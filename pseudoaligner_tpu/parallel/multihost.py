"""Multi-host execution: jax.distributed init + cross-host count merging.

The reference is single-process (SURVEY.md §2.3); this is the launcher
layer that takes the mesh modes multi-host.  The production pattern for
serving is per-host data parallelism: every host holds the full index
(or its kpart shard), streams its own slice of the input FASTQ, maps
locally, and the per-transcript/per-EC count vectors are all-reduced
across hosts by XLA's collectives — the cross-host analog of the reference's
mpsc result channel (src/pseudoaligner.rs:430-474).

Host FASTQ sharding is by batch stride: host p maps batches
p, p+H, p+2H, ... of the stream — contiguous-enough for file readahead,
and deterministic (no coordination needed beyond the process count).
Per-read records are written per-host (part-<p> files); merged counts are
identical on every host after the psum.

Validated without real multi-host hardware by tests/test_multihost.py:
it spawns separate OS processes, each `jax.distributed.initialize`-d
with its own virtual CPU devices, builds the GLOBAL mesh, and checks the
merged counts equal a single-process run (the same code path a
multi-host GPU deployment runs).
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import READS_AXIS


def init_from_env() -> tuple[int, int]:
    """Initialize jax.distributed from PA_COORDINATOR / PA_NUM_PROCESSES /
    PA_PROCESS_ID (no-op if PA_NUM_PROCESSES is absent or 1).

    Nothing tells JAX of a GPU cluster by itself, so the coordinator
    address, process count and process id come from these variables
    (also used for CPU simulation).
    Returns (process_index, process_count)."""
    import jax

    nproc = int(os.environ.get("PA_NUM_PROCESSES", "1"))
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=os.environ["PA_COORDINATOR"],
            num_processes=nproc,
            process_id=int(os.environ["PA_PROCESS_ID"]),
        )
    elif os.environ.get("PA_AUTO_DISTRIBUTED"):
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = READS_AXIS):
    """Mesh over ALL global devices (every process sees the same mesh;
    each host feeds its addressable shard)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def make_count_merge(mesh, n_tx: int, axis: str = READS_AXIS):
    """Jitted global all-reduce of per-host count vectors.

    Each process passes its LOCAL count vector; the result (identical on
    every host) is the global sum.  Used to merge per-host TCC/idxstats
    accumulations after per-host streaming — one collective per file,
    not per batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = mesh.devices.size

    def merge(local_counts):
        # [1, n_tx] per-device block -> [n_tx] psum over the axis
        return jax.lax.psum(jnp.sum(local_counts, axis=0), axis)

    fn = jax.jit(
        jax.shard_map(
            merge, mesh=mesh, in_specs=P(axis), out_specs=P(),
            check_vma=False,
        )
    )

    def run(local_counts: np.ndarray):
        import jax

        # int32 on purpose: without jax_enable_x64 the device collective
        # would silently downcast int64 anyway, so declare the real
        # ceiling (2^31 reads/transcript/run) instead of implying 64-bit
        # safety; callers needing more should host-sum numpy int64.
        local_counts = np.asarray(local_counts, dtype=np.int32)
        # each host's vector rides on its FIRST local device (zeros on the
        # rest); the psum over all devices is then the sum over hosts
        n_local = len(mesh.local_devices)
        local_block = np.zeros((n_local, n_tx), dtype=np.int32)
        local_block[0] = local_counts
        garr = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axis)), local_block, (ndev, n_tx)
        )
        return np.asarray(jax.device_get(fn(garr)))

    return run


def shard_batches(batches, process_index: int, process_count: int):
    """Deterministic per-host batch stride: host p takes batches
    p, p+H, ...  (generator passthrough)."""
    for i, b in enumerate(batches):
        if i % process_count == process_index:
            yield b


def map_fastq_multihost(
    image,
    config,
    fastq_path: str,
    outdir: str,
    process_index: int | None = None,
    process_count: int | None = None,
    resume: bool = False,
):
    """Per-host streaming map of a FASTQ slice + global count merge.

    Every host runs this with the same arguments after init_from_env();
    host p writes records for its batches to `part-<p>.txt` in outdir and
    all hosts return the identical merged per-transcript count vector.

    Crash containment (same contract as the single-host CLI progress
    file): after each batch's records flush, `part-<p>.progress` is
    atomically replaced with (batches_done, byte_offset) and the host's
    running count vector checkpoints beside it — a SIGKILL mid-run never
    desyncs them.  With `resume=True` a restarted job truncates the part
    file to the last durable offset, reloads the counts, skips the
    completed batches and continues; the final outputs are byte-identical
    to an uninterrupted run."""
    import jax

    from ..io.fastq import FastqReader
    from ..models.aligner import Pseudoaligner

    p = jax.process_index() if process_index is None else process_index
    H = jax.process_count() if process_count is None else process_count

    aligner = Pseudoaligner(image, config)
    reader = FastqReader(
        fastq_path, batch_size=config.batch_size, max_len=config.max_read_len
    )
    os.makedirs(outdir, exist_ok=True)
    n_tx = len(image.tx_names)
    local_counts = np.zeros(n_tx, dtype=np.int64)
    part_path = os.path.join(outdir, f"part-{p}.txt")
    prog_path = part_path + ".progress"
    done_batches = 0
    if resume and os.path.exists(prog_path):
        try:
            # ONE atomic artifact: (batches, offset, counts) land together
            # or not at all — two separate files would open a crash window
            # where counts include a batch progress doesn't, double-
            # counting it on resume
            ckpt = np.load(prog_path)
            done_batches = int(ckpt["batches"])
            byte_off = int(ckpt["offset"])
            local_counts = ckpt["counts"].astype(np.int64)
            with open(part_path, "r+b") as f:  # drop any torn tail
                f.truncate(byte_off)
        except Exception:
            done_batches = 0
            local_counts = np.zeros(n_tx, dtype=np.int64)

    try:
        from ..io import native as _native  # noqa: F401

        # force the lazy builds: the import alone always succeeds (pure
        # ctypes wrapper), so without probing, a toolchain-less host
        # would take the emitter path and crash mid-serve instead of
        # using the fallback below (review r5)
        _native._load()
        _native._load_emit()
        have_native = True
    except Exception:
        have_native = False

    # release the reader's mmap / gz producer thread even when the
    # serve loop raises (corrupt stream, device error) -- same
    # finally-close contract as the single-host count path (review r5)
    try:
        with open(part_path, "ab" if done_batches else "wb") as out:
            skip = done_batches  # snapshot: done_batches advances as we write

            def strided():
                for i, batch in enumerate(shard_batches(reader, p, H)):
                    if i < skip:
                        continue  # already durably written before the crash
                    yield batch

            def checkpoint():
                # durable-progress contract: flush records FIRST, then
                # atomically replace the single (batches, offset, counts)
                # checkpoint
                out.flush()
                tmp = prog_path + ".tmp.npz"
                np.savez(tmp, batches=done_batches, offset=out.tell(),
                         counts=local_counts)
                os.replace(tmp, prog_path)

            if have_native and aligner.meta.distinct_cap > 0:
                # production path: the signature-indirect native emitter +
                # DepthPipeline serving loop (same engine as single-host
                # `emit_fastq`, VERDICT r3 item 3) — count_cb fires at each
                # batch's ordered finish, after its records hit `out`, so the
                # checkpoint's (offset, counts) stay crash-consistent
                def count_cb(_n, deltas):
                    nonlocal done_batches
                    for ids, w in deltas:
                        np.add.at(local_counts, np.asarray(ids, dtype=np.int64),
                                  np.asarray(w, dtype=np.int64))
                    done_batches += 1
                    checkpoint()

                aligner.emit_fastq(fastq_path, out, batch_iter=strided(),
                                   count_cb=count_cb)
            else:
                # no-toolchain fallback: per-record Python formatting with
                # pipeline_depth map steps kept in flight (pipeline.py)
                from ..pipeline import DepthPipeline

                def write_records(item, _nxt):
                    res, b = item
                    for rec in aligner.records_from_result(
                            jax.device_get(res), b):
                        out.write(rec.format_reference_style().encode() + b"\n")
                        for t in rec.eq_class:
                            local_counts[t] += 1
                    nonlocal done_batches
                    done_batches += 1
                    checkpoint()

                pipe = DepthPipeline(getattr(config, "pipeline_depth", 1),
                                     write_records)
                for batch in strided():
                    res = aligner.map_batch_device(batch.codes, batch.lens)
                    pipe.push((res, batch))
                pipe.close()
    finally:
        reader.close()

    mesh = global_mesh()
    merged = make_count_merge(mesh, n_tx)(local_counts)
    return merged
