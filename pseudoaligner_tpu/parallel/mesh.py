"""Data-parallel scale-out over a device mesh.

The reference has no distributed layer (SURVEY.md §2.3): its parallelism is
worker threads over a mutexed FASTQ iterator (src/pseudoaligner.rs:430-474).
The equivalent here is a first-class sharding layer:

- mesh axis `reads`: the batch dimension is sharded across devices via
  `shard_map`; the index (the read-only "model") is replicated;
- per-EC / per-transcript compatibility counts are reduced across the mesh
  with `psum` (NCCL between GPUs), replacing the reference's mpsc
  result channel;
- multi-host: each host feeds its local FASTQ shard (per-host input
  pipeline), with `jax.distributed` initialization left to the launcher.

The k-mer-partitioned (sharded-index) mode with all-to-all lookup exchange
ships in `parallel/sharded_index.py` (lookup-sharded and graph-sharded
variants; SURVEY.md §7.2 step 6).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AlignerConfig
from ..ops.map_kernel import (
    DeviceIndex,
    MapMeta,
    MapResult,
    map_batch_packed,
    pack_reads_host,
)

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over `devices` (default: all global devices).  Multi-host
    per-host engines pass jax.local_devices() — pod serving is per-host
    data parallel, with only the count merge on the global mesh."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            # a silently smaller mesh would run (say) 4-way while the
            # caller benchmarks "8-way" scaling (review r5)
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def tx_compat_counts(result: MapResult, n_tx: int) -> jnp.ndarray:
    """Per-transcript compatibility counts from EC bitsets: counts[t] =
    number of reads whose equivalence class contains transcript t."""
    bits = result.ec_bits  # [B, TW] uint32
    shifts = jnp.arange(32, dtype=jnp.uint32)
    unpacked = (bits[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    per_tx = unpacked.reshape(bits.shape[0], -1)[:, :n_tx]
    return jnp.sum(per_tx.astype(jnp.int32), axis=0)


def make_sharded_step(meta: MapMeta, mesh: Mesh, n_tx: int, axis: str = READS_AXIS):
    """Build the jitted distributed mapping step.

    Returns fn(dev_index, reads [B, L], lens [B]) ->
        (MapResult sharded over `axis`, counts [n_tx] replicated)
    where B must be divisible by the mesh axis size.  The per-read results
    stay sharded (each host consumes its shard); the TCC count vector is
    psum-reduced across the mesh.
    """

    def local_step(idx: DeviceIndex, packed, lens):
        res = map_batch_packed(meta, idx, packed, lens)
        counts = tx_compat_counts(res, n_tx)
        counts = jax.lax.psum(counts, axis)
        return res, counts

    idx_spec = jax.tree.map(lambda _: P(), DeviceIndex(*[0] * len(DeviceIndex._fields)))
    shard_spec_in = (idx_spec, P(axis), P(axis))
    out_spec = (
        MapResult(
            mapped=P(axis),
            coverage=P(axis),
            mismatches=P(axis),
            nodes=P(axis),
            n_nodes=P(axis),
            ec_bits=P(axis),
            ec_distinct=P(axis),
        ),
        P(),
    )
    fn = jax.shard_map(
        local_step, mesh=mesh, in_specs=shard_spec_in, out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(fn)


def replicate_index(dev: DeviceIndex, mesh: Mesh) -> DeviceIndex:
    """Place the index replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), dev)


def shard_batch(reads, lens, mesh: Mesh, axis: str = READS_AXIS):
    sharding = NamedSharding(mesh, P(axis))
    return (
        jax.device_put(reads, sharding),
        jax.device_put(lens, sharding),
    )


class ShardedAligner:
    """Data-parallel mapping engine over a mesh (index replicated)."""

    def __init__(self, image, config: AlignerConfig, mesh: Mesh | None = None):
        from ..ops.map_kernel import device_index_from_image

        self.mesh = mesh if mesh is not None else make_mesh()
        import dataclasses

        dev, meta = device_index_from_image(image, config)
        # the psum TCC-count path consumes EC bitsets on device; the walk
        # cap must be off with it — its exact-fallback channel (-3 marker)
        # only exists in the compact output.  The UNCAPPED walk needs the
        # full node buffer (2*read_len bound, config.py) exactly like the
        # host-remap fallback: a serving-sized max_nodes would silently
        # truncate visits on fragmented reads (review r5).
        meta = dataclasses.replace(
            meta, distinct_cap=0, max_walk_iters=0, max_left_iters=0,
            max_nodes=max(meta.max_nodes, 2 * meta.read_len),
        )
        if meta.tx_words == 0:
            # ec_bits would be [B, 0] and every count silently empty
            raise ValueError(
                f"ShardedAligner's bitset TCC path needs n_tx "
                f"({len(image.tx_names)}) <= "
                f"config.bitset_tx_threshold ({config.bitset_tx_threshold})"
            )
        self.meta = meta
        self.config = config
        self.n_tx = len(image.tx_names)
        self.dev = replicate_index(DeviceIndex(*[jnp.asarray(a) for a in dev]), self.mesh)
        self._step = make_sharded_step(meta, self.mesh, self.n_tx)

    def map_batch(self, reads: np.ndarray, lens: np.ndarray):
        nd = self.mesh.devices.size
        B = reads.shape[0]
        if B % nd:
            raise ValueError(f"batch {B} not divisible by mesh size {nd}")
        packed = pack_reads_host(np.asarray(reads, dtype=np.uint8))
        r, l = shard_batch(packed, lens.astype(np.int32), self.mesh)
        return self._step(self.dev, r, l)
