#!/usr/bin/env python3
"""Serve-init A/B: the packed upload against a plain device_put.

Builds chip_smoke's seeded GENCODE-format transcriptome index (100 Mb
of novel sequence by default, same seed) and times, in one process, the
step that puts the serving index on the device:

  plain   device_index_from_image (devcache) + the cuckoo-mode dummies
          + jax.device_put
  packed  serving_device_index: the packed sidecar, H2D of the packed
          bytes and the on-device unpack

Both first serves start with neither disk cache, so each builds the
device image and writes what its path caches (plain: the devcache;
packed: the devcache and the sidecar).  Warm serves follow in the order
plain, packed, packed, plain, with both caches on disk (and in the OS
page cache, as they were just written).  Loading the .idx file is common
to both arms and timed once.  Every serve's device image must equal the
first's.  One JSON line per serve, each naming the card.

Usage: python tools/upload_ab.py [--novel-mb 100] [--seed 0] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--novel-mb", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir",
                   default=os.path.join(REPO, ".smoke_work", "upload_ab"))
    return p.parse_args(argv)


def run(opts, card: str) -> bool:
    """Build the index, serve it six times; True when every device
    image equals the first."""
    import jax

    from pseudoaligner_tpu import cli, synth
    from pseudoaligner_tpu.coldstart import JitEventMonitor
    from pseudoaligner_tpu.jaxcache import enable_compilation_cache
    from pseudoaligner_tpu.ops.map_kernel import (
        _probe_dummies, device_index_from_image, serving_device_index)
    from pseudoaligner_tpu.serde import load_index

    def report(**numbers):
        print(json.dumps({**numbers, "card": card}), flush=True)

    enable_compilation_cache()
    os.makedirs(opts.workdir, exist_ok=True)
    fa = os.path.join(opts.workdir, "tx.fa")
    idx = os.path.join(opts.workdir, "tx.idx")
    seqs, names, gmap = synth.transcriptome(
        novel_bases=int(opts.novel_mb * 1e6), seed=opts.seed + 99)
    synth.write_fasta(fa, seqs, names, gmap)
    if cli.main(["index", "-n", str(os.cpu_count()), "-i", idx, fa]) != 0:
        raise RuntimeError("index build failed")
    t0 = time.perf_counter()
    image = load_index(idx)
    report(load_index_s=time.perf_counter() - t0,
           kmers=int(image.kmer_keys.shape[0]))
    cfg = cli._serving_config(image.k, argparse.Namespace(
        batch_size=65536, max_read_len=100))

    def caches():
        return sorted(glob.glob(idx + ".dev-*.npz")
                      + glob.glob(idx + ".pack-*.npz"))

    def plain():
        dev, _meta = device_index_from_image(image, cfg)
        return jax.device_put(
            dev._replace(**_probe_dummies(dev.kmer_keys.shape[1])))

    def packed():
        return serving_device_index(image, cfg)[0]

    first = None
    all_same = True
    for serve, arm, fn in (("first", "plain", plain),
                           ("first", "packed", packed),
                           ("warm", "plain", plain),
                           ("warm", "packed", packed),
                           ("warm", "packed", packed),
                           ("warm", "plain", plain)):
        if serve == "first":
            for f in caches():
                os.remove(f)
        mon = JitEventMonitor().start()
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        seconds = time.perf_counter() - t0
        mon.stop()
        jit = mon.summary()
        host = jax.device_get(out)
        del out
        first = host if first is None else first
        same = all(np.array_equal(a, b) for a, b in zip(host, first))
        all_same &= same
        report(serve=serve, arm=arm, seconds=seconds,
               compile_s=jit["xla_compile_s"], cache_hits=jit["cache_hits"],
               cache_misses=jit["cache_misses"], same_as_first=same,
               device_bytes=int(sum(a.nbytes for a in host)),
               disk_caches={os.path.basename(f): os.path.getsize(f)
                            for f in caches()})
    return all_same


def main(argv=None) -> int:
    opts = parse_args(argv)
    from pseudoaligner_tpu.backend import describe

    if describe()["platform"] != "gpu":
        print("upload_ab needs a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    ok = run(opts, card)
    shutil.rmtree(opts.workdir)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
