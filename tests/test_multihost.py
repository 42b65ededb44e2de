"""Real multi-process execution: two OS processes, each with its own
virtual CPU devices, jax.distributed-coordinated into one global mesh.

This validates the multi-host serving pattern end to end (per-host FASTQ
batch striding, per-host record parts, global count psum) — the same
code path a multi-host GPU deployment runs, on CPU devices.  The reference has no
distributed layer (SURVEY.md §2.3)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from pseudoaligner_tpu.parallel.multihost import init_from_env, map_fastq_multihost
from pseudoaligner_tpu.serde import load_index
from pseudoaligner_tpu.config import AlignerConfig

pid, n = init_from_env()
assert n == 2, n
image = load_index({index!r})
cfg = AlignerConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
merged = map_fastq_multihost(image, cfg, {fastq!r}, {outdir!r})
np.save(os.path.join({outdir!r}, f"counts-{{pid}}.npy"), merged)
print("child", pid, "ok")
"""


_KPART_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from pseudoaligner_tpu.parallel.multihost import init_from_env, global_mesh
from pseudoaligner_tpu.parallel.sharded_index import KmerPartitionedAligner
from pseudoaligner_tpu.models.aligner import Pseudoaligner
from pseudoaligner_tpu.serde import load_index
from pseudoaligner_tpu.config import AlignerConfig

pid, n = init_from_env()
assert n == 2, n
import jax
image = load_index({index!r})
cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=64,
                    lazy_seeds=False, left_compact=0.0)
mesh = global_mesh()  # 2 procs x 2 local devices -> 4-way kpart
assert mesh.devices.size == 4
kp = KmerPartitionedAligner(image, cfg, mesh, shard_graph={shard_graph})
data = np.load({reads!r})
codes, lens = data["codes"], data["lens"]
res, counts = kp.map_batch(codes, lens)
# expected: the replicated single-device engine on this host
base = Pseudoaligner(image, cfg).map_batch_device(codes, lens)
exp = {{f: np.asarray(getattr(base, f))
       for f in ("mapped", "coverage", "mismatches", "ec_distinct")}}
for f, e in exp.items():
    arr = getattr(res, f)
    shards = arr.addressable_shards
    assert shards, f
    for sh in shards:
        assert np.array_equal(np.asarray(sh.data), e[sh.index]), (f, pid)
open(os.path.join({outdir!r}, f"kpart-ok-{{pid}}"), "w").write("ok")
print("child", pid, "kpart ok")
"""


@pytest.mark.full
@pytest.mark.parametrize("shard_graph", [False, True])
def test_two_process_kpart_sharded_index(small_index, small_reads, tmp_path,
                                         shard_graph):
    """The k-mer-partitioned engine over a GLOBAL mesh spanning two OS
    processes (2 local devices each): index shards live per-process
    (the index-beyond-one-host mode), all_to_all routing crosses the
    process boundary, and every addressable output shard must be
    bit-identical to the replicated single-device engine."""
    from pseudoaligner_tpu.config import AlignerConfig  # noqa: F401
    from pseudoaligner_tpu.serde import save_index

    index_path = str(tmp_path / "idx.bin")
    save_index(small_index, index_path)
    B, L = 64, 64
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(small_reads[:B]):
        w = c[:60]
        codes[j, : len(w)] = w
        lens[j] = len(w)
    reads_path = str(tmp_path / "reads.npz")
    np.savez(reads_path, codes=codes, lens=lens)
    outdir = str(tmp_path / "out")
    os.makedirs(outdir, exist_ok=True)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH")
    }
    procs = []
    for pid in range(2):
        env = dict(
            env_base,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            PA_COORDINATOR=f"127.0.0.1:{port}",
            PA_NUM_PROCESSES="2",
            PA_PROCESS_ID=str(pid),
        )
        code = _KPART_CHILD.format(repo=REPO, index=index_path,
                                   reads=reads_path, outdir=outdir,
                                   shard_graph=shard_graph)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    for pid in range(2):
        assert os.path.exists(os.path.join(outdir, f"kpart-ok-{pid}"))


@pytest.mark.full
def test_two_process_global_count_merge(small_index, small_reads, tmp_path):
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.serde import save_index

    # fixture data: 64 bundled reads in a fresh FASTQ
    fastq = tmp_path / "reads.fq"
    with open(fastq, "w") as f:
        for rid, codes in small_reads[:64]:
            seq = "".join("ACGT"[c] for c in codes)
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    index_path = str(tmp_path / "idx.bin")
    save_index(small_index, index_path)
    outdir = str(tmp_path / "out")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH")
    }
    procs = []
    for pid in range(2):
        env = dict(
            env_base,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PA_COORDINATOR=f"127.0.0.1:{port}",
            PA_NUM_PROCESSES="2",
            PA_PROCESS_ID=str(pid),
        )
        code = _CHILD.format(
            repo=REPO, index=index_path, fastq=str(fastq), outdir=outdir
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", code],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    c0 = np.load(os.path.join(outdir, "counts-0.npy"))
    c1 = np.load(os.path.join(outdir, "counts-1.npy"))
    assert np.array_equal(c0, c1), "merged counts must agree on all hosts"

    # single-process reference
    cfg = AlignerConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    al = Pseudoaligner(small_index, cfg)
    ref = np.zeros(len(small_index.tx_names), dtype=np.int64)
    n_recs = 0
    for rec in al.map_fastq(str(fastq)):
        n_recs += 1
        for t in rec.eq_class:
            ref[t] += 1
    assert np.array_equal(c0, ref)

    # the part files together cover every read exactly once
    lines = []
    for p in range(2):
        lines += open(os.path.join(outdir, f"part-{p}.txt")).read().splitlines()
    assert len(lines) == n_recs == 64


_RESUME_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
die_after = {die_after}
if die_after:
    # crash on the per-batch render step of whichever serving path runs:
    # emit_finish (native fast path, on the render worker thread) or
    # records_from_result (no-toolchain record fallback) — shared counter
    import pseudoaligner_tpu.models.aligner as A
    _calls = [0]
    def _maybe_die():
        _calls[0] += 1
        if _calls[0] > die_after:
            os._exit(137)  # hard crash mid-run (no flush, no cleanup)
    _orig_rec = A.Pseudoaligner.records_from_result
    def _wrapped_rec(self, res, b):
        _maybe_die()
        return _orig_rec(self, res, b)
    A.Pseudoaligner.records_from_result = _wrapped_rec
    _orig_fin = A.Pseudoaligner.emit_finish
    def _wrapped_fin(self, st):
        _maybe_die()
        return _orig_fin(self, st)
    A.Pseudoaligner.emit_finish = _wrapped_fin
from pseudoaligner_tpu.parallel.multihost import init_from_env, map_fastq_multihost
from pseudoaligner_tpu.serde import load_index
from pseudoaligner_tpu.config import AlignerConfig

pid, n = init_from_env()
image = load_index({index!r})
cfg = AlignerConfig(k=20, batch_size=8, max_read_len=64, max_nodes=64)
merged = map_fastq_multihost(image, cfg, {fastq!r}, {outdir!r}, resume=True)
np.save(os.path.join({outdir!r}, f"counts-{{pid}}.npy"), merged)
print("child", pid, "ok")
"""


@pytest.mark.full
def test_multihost_kill_restart_resume(small_index, small_reads, tmp_path):
    """Failure containment across hosts: SIGKILL-equivalent crash of BOTH
    processes mid-stream (after some batches durably flushed), then a
    resumed restart — part files and the merged count vector must equal
    an uninterrupted run's byte for byte (the durable-progress contract
    of map_fastq_multihost)."""
    from pseudoaligner_tpu.serde import save_index

    fastq = tmp_path / "reads.fq"
    with open(fastq, "w") as f:
        for rid, codes in small_reads[:128]:
            seq = "".join("ACGT"[c] for c in codes)
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    index_path = str(tmp_path / "idx.bin")
    save_index(small_index, index_path)

    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH")
    }

    def launch(outdir, die_after):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for pid in range(2):
            env = dict(
                env_base,
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2",
                PA_COORDINATOR=f"127.0.0.1:{port}",
                PA_NUM_PROCESSES="2",
                PA_PROCESS_ID=str(pid),
            )
            code = _RESUME_CHILD.format(repo=REPO, index=index_path,
                                        fastq=str(fastq), outdir=outdir,
                                        die_after=die_after)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            ))
        return [p.communicate(timeout=600) for p in procs], procs

    # reference: uninterrupted run
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir, exist_ok=True)
    outs, procs = launch(ref_dir, die_after=0)
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    # crash run: both children die mid-stream, some batches flushed.
    # die_after=6 of 8 per-host batches: with the depth-3 pipeline the
    # ordered finish (durable checkpoint) trails the render by ~depth
    # batches, so an earlier crash could fire before ANY checkpoint
    crash_dir = str(tmp_path / "crash")
    os.makedirs(crash_dir, exist_ok=True)
    outs, procs = launch(crash_dir, die_after=6)
    # both children die mid-stream: at least one by the injected hard
    # crash (137); the peer may instead die from the broken coordination
    # first, with some nonzero code — either way no child succeeds
    assert all(p.returncode != 0 for p in procs)
    assert any(p.returncode == 137 for p in procs)
    n_prog = 0
    for pid in range(2):
        prog = os.path.join(crash_dir, f"part-{pid}.txt.progress")
        if os.path.exists(prog):
            assert int(np.load(prog)["batches"]) >= 1  # durable progress
            n_prog += 1
    assert n_prog >= 1

    # restart with resume: outputs must equal the uninterrupted run
    outs, procs = launch(crash_dir, die_after=0)
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    for pid in range(2):
        a = open(os.path.join(ref_dir, f"part-{pid}.txt"), "rb").read()
        b = open(os.path.join(crash_dir, f"part-{pid}.txt"), "rb").read()
        assert a == b, f"part-{pid} diverged after resume"
        ca = np.load(os.path.join(ref_dir, f"counts-{pid}.npy"))
        cb = np.load(os.path.join(crash_dir, f"counts-{pid}.npy"))
        assert np.array_equal(ca, cb)


def test_multihost_gz_input_parity(small_index, small_reads, tmp_path):
    """map_fastq_multihost over a gzipped FASTQ (single process, no
    distributed init) writes byte-identical part files and counts to the
    plain-file run — the strided emit path composes with the gz scanner."""
    import gzip

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.parallel.multihost import map_fastq_multihost

    fastq = tmp_path / "reads.fq"
    with open(fastq, "w") as f:
        for rid, codes in small_reads[:64]:
            seq = "".join("ACGT"[c] for c in codes)
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    gz = tmp_path / "reads.fq.gz"
    with open(fastq, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())

    cfg = AlignerConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    out_a = tmp_path / "a"
    out_b = tmp_path / "b"
    ca = map_fastq_multihost(small_index, cfg, str(fastq), str(out_a),
                             process_index=0, process_count=1)
    cb = map_fastq_multihost(small_index, cfg, str(gz), str(out_b),
                             process_index=0, process_count=1)
    assert np.array_equal(ca, cb)
    a = open(out_a / "part-0.txt", "rb").read()
    b = open(out_b / "part-0.txt", "rb").read()
    assert a == b and len(a) > 0
