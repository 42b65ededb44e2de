"""Multi-process (multi-host analog) throughput bench.

Spawns N coordinated OS processes (jax.distributed over 127.0.0.1), each
with its own virtual CPU devices, mapping its stride of a shared
synthetic read stream in the serving shape — the process layout of a
multi-host deployment, on CPU devices.  Reports aggregate reads/s per process count and
efficiency vs one process.

On a small host the meaningful sweep is 1 -> 2 processes (x2
virtual devices each saturates the cores); multi-host numbers come from
running the same children on actual hosts (parallel/multihost.py
init_from_env reads PA_COORDINATOR / PA_NUM_PROCESSES / PA_PROCESS_ID).

Usage:
    python tools/multihost_bench.py \
        [--procs 1 2] [--devices-per-proc 2] [--batches 6] [--json]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import jax
from pseudoaligner_tpu.parallel.multihost import init_from_env, shard_batches
from pseudoaligner_tpu.parallel.mesh import ShardedAligner, make_mesh
from pseudoaligner_tpu.serde import load_index
from pseudoaligner_tpu.config import AlignerConfig

pid, H = init_from_env()
image = load_index({index!r})
B = {batch!r}
cfg = AlignerConfig(k=20, batch_size=B, max_read_len=60, max_nodes=9,
                    distinct_cap=3, max_walk_iters=3, max_left_iters=2)
# per-host engine over the host's own devices: pod serving is per-host
# data parallel (the global mesh is only needed for the count merge)
eng = ShardedAligner(image, cfg, make_mesh(len(jax.local_devices()),
                                           devices=jax.local_devices()))
data = np.load({reads!r})
reads, lens = data["reads"], data["lens"]
nb = reads.shape[0] // B
batches = [(reads[i*B:(i+1)*B], lens[i*B:(i+1)*B]) for i in range(nb)]
mine = list(shard_batches(batches, pid, H))
# warm/compile on the first local batch (untimed)
jax.block_until_ready(eng.map_batch(*mine[0]))
t0 = time.time()
outs = [eng.map_batch(c, l) for c, l in mine]
jax.device_get(outs)
dt = time.time() - t0
with open(os.path.join({outdir!r}, f"res-{{pid}}.json"), "w") as f:
    json.dump({{"pid": pid, "n_reads": B * len(mine), "seconds": dt}}, f)
print("child", pid, "ok", flush=True)
"""


def run_group(nproc, dev_per_proc, index_path, reads_path, batch, outdir,
              pin_cores=0):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH")
    }
    procs = []
    for pid in range(nproc):
        env = dict(
            env_base,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={dev_per_proc}",
            PA_COORDINATOR=f"127.0.0.1:{port}",
            PA_NUM_PROCESSES=str(nproc),
            PA_PROCESS_ID=str(pid),
        )
        code = _CHILD.format(repo=REPO, index=index_path, reads=reads_path,
                             outdir=outdir, batch=batch)
        argv = [sys.executable, "-c", code]
        if pin_cores:
            lo = pid * pin_cores
            cores = ",".join(str(c) for c in range(lo, lo + pin_cores))
            argv = ["taskset", "-c", cores] + argv
        procs.append(subprocess.Popen(argv, env=env))
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        raise RuntimeError(f"child failed: rcs={rcs}")
    res = []
    for pid in range(nproc):
        with open(os.path.join(outdir, f"res-{pid}.json")) as f:
            res.append(json.load(f))
    total = sum(r["n_reads"] for r in res)
    # aggregate rate over the slowest child (they run concurrently)
    return total / max(r["seconds"] for r in res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--pin-cores", type=int, default=0,
                    help="pin each child to this many DEDICATED cores via "
                         "taskset (proc p -> cores [p*N, p*N+N)); isolates "
                         "per-host resources so weak scaling measures the "
                         "coordination layer, not host core contention")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    import numpy as np

    import bench as benchmod
    from pseudoaligner_tpu.serde import save_index

    image = benchmod.build_or_load_index()
    n_total = args.batch * args.batches * max(args.procs)
    reads, lens = benchmod.synth_reads(image, n_total)
    tmp = tempfile.mkdtemp(prefix="pa_mh_bench_")
    index_path = benchmod.INDEX_CACHE
    if not os.path.exists(index_path):
        index_path = os.path.join(tmp, "idx.bin")
        save_index(image, index_path)
    reads_path = os.path.join(tmp, "reads.npz")
    np.savez(reads_path, reads=reads, lens=lens)

    results = {}
    for nproc in args.procs:
        t0 = time.time()
        rps = run_group(nproc, args.devices_per_proc, index_path,
                        reads_path, args.batch, tmp,
                        pin_cores=args.pin_cores)
        results[nproc] = rps
        base = results[args.procs[0]]
        eff = rps / (base * nproc / args.procs[0])
        print(f"procs={nproc} (x{args.devices_per_proc} dev): {rps:,.0f} "
              f"reads/s  efficiency={eff:.1%}  (wall {time.time()-t0:.0f}s)")

    if args.json:
        base = results[args.procs[0]]
        print(json.dumps({
            "mode": "multihost-dp", "platform": "cpu-virtual",
            "devices_per_proc": args.devices_per_proc,
            "reads_per_s": {str(n): round(r) for n, r in results.items()},
            "efficiency": {
                str(n): round(r / (base * n / args.procs[0]), 4)
                for n, r in results.items()
            },
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
