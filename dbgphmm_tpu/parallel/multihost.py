"""Multi-host launch: ``jax.distributed`` initialization, per-host read
slicing, and DCN-aware read-sharded scoring.

The reference's only parallelism is shared-memory rayon fan-out over reads
(ref: freq.rs:175-192, hint.rs:199-220); its multi-node story is cluster
job resubmission (scripts/sim.sh:165-182).  Here the same data parallelism
extends across hosts: every process holds the (small) graph replicated,
loads its contiguous slice of the read collection, and the per-read
log-likelihood sum rides XLA's cross-host psum — the only
cross-device reduction the algorithm needs (BASELINE.json north star:
>=80% reads/s scaling from 1 chip to >=2 hosts).

Launch recipe (one command per host; CPU smoke shown; under a cluster
scheduler jax.distributed recognizes, such as SLURM, the explicit
addresses can be omitted):

    # host 0
    python -m dbgphmm_tpu --dist localhost:12345,2,0 sample ...
    # host 1
    python -m dbgphmm_tpu --dist localhost:12345,2,1 sample ...

Every host runs the identical host-side program (graph ops, flow solver,
neighbor generation are deterministic), so control flow never diverges;
only device arrays are sharded.  Tested with a 2-process CPU mesh in
tests/test_multihost.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed.  Pass coordinator host:port, process
    count, and this process's id; all three may be None under a cluster
    scheduler jax.distributed detects.  Must run before any other jax
    call."""
    import jax

    try:
        # cross-process collectives on the CPU backend need gloo
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def parse_dist_arg(spec: str) -> Tuple[str, int, int]:
    """``"host:port,n_processes,process_id"`` -> tuple."""
    addr, n, i = spec.rsplit(",", 2)
    return addr, int(n), int(i)


def global_mesh(cand_axis: int = 1):
    """("cand", "reads") mesh over ALL devices of ALL processes.  The
    "reads" axis spans hosts, so read sharding crosses DCN; candidate
    sharding stays host-local when cand_axis <= local device count."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    n = devs.size
    assert n % cand_axis == 0, (n, cand_axis)
    return Mesh(devs.reshape(cand_axis, n // cand_axis),
                axis_names=("cand", "reads"))


def process_read_slice(n_reads: int, mesh) -> slice:
    """Contiguous slice of the (padded) read batch owned by this process.

    The global read axis is laid out device-major in ``jax.devices()``
    order, which enumerates processes in process_index order — so each
    process owns one contiguous block of the padded batch."""
    import jax

    n_dev = mesh.devices.size
    n_pad = -(-n_reads // n_dev) * n_dev
    per_proc = n_pad // jax.process_count()
    i = jax.process_index()
    return slice(i * per_proc, (i + 1) * per_proc)


def put_read_sharded_global(mesh, global_arr: np.ndarray, axis: int,
                            fill=0):
    """Shard ``global_arr`` along ``axis`` over every device of the global
    mesh, feeding only this process's slice to the runtime.

    ``global_arr`` is the full (logical) array — each host typically
    materializes only its ``process_read_slice`` and passes a same-shaped
    array with garbage elsewhere; only the local block is read."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = np.asarray(global_arr)
    n_dev = mesh.devices.size
    pad = (-arr.shape[axis]) % n_dev
    if pad:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = np.pad(arr, widths, constant_values=fill)
    spec = [None] * arr.ndim
    spec[axis] = ("cand", "reads")
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    sl = [slice(None)] * arr.ndim
    n_local = arr.shape[axis] // jax.process_count()
    i = jax.process_index()
    sl[axis] = slice(i * n_local, (i + 1) * n_local)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(arr[tuple(sl)])
    )


def put_replicated_global(mesh, tree):
    """Replicate a pytree on every device of the global mesh (multi-process
    safe: every host passes identical values)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.device_put(tree, repl)
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: jax.make_array_from_callback(
            jnp.shape(a), repl, lambda idx, _a=a: np.asarray(_a)[idx]
        ),
        tree,
    )


def distributed_forward_total(dm, codes: np.ndarray, lens: np.ndarray,
                              mesh) -> float:
    """Total log P(R | model) with reads sharded across all hosts' devices.
    Every host passes the same logical (global) codes/lens — or arrays
    whose non-local blocks are padding — and receives the same total."""
    import jax
    import jax.numpy as jnp

    from ..ops.forward import forward_scores

    codes_d = put_read_sharded_global(mesh, codes, 0, fill=-1)
    lens_d = put_read_sharded_global(mesh, lens, 0, fill=0)
    dm_d = put_replicated_global(mesh, dm)

    @jax.jit
    def total(dm, codes, lens):
        scores = forward_scores(dm, codes, lens, renorm=True)
        return jnp.sum(jnp.where(lens > 0, scores, 0.0))

    out = total(dm_d, codes_d, lens_d)
    # the jitted sum produces a fully-replicated scalar; every process can
    # read it locally
    return float(np.asarray(jax.device_get(out)))
