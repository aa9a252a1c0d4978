"""dbgphmm_tpu — accelerator-native Bayesian genome assembly engine.

A from-scratch reimplementation of the capabilities of ryought/dbgphmm
designed around the accelerator:

* Host Python owns graph topology, combinatorics and I/O (k-DBG construction,
  simple-path compaction, convex min-cost flow, Euler circuits, serialization).
* The device (via JAX/XLA/Pallas) owns the hot kernel: batched log-space
  profile-HMM forward/backward dynamic programming over the DBG's sparse
  transition structure, evaluated for (many reads x many candidate copy-number
  assignments), parallelized over a `jax.sharding.Mesh` of GPUs.

Layer map (mirrors reference SURVEY.md section 1):
  prob        -- log-space probability scalars            (ref: src/prob.rs)
  seq         -- sequences, reads, genomes, FASTA I/O     (ref: src/common/collection.rs)
  kmer        -- k-mer utilities                          (ref: src/kmer/)
  graph       -- DiGraph, compaction, euler, k-shortest   (ref: src/graph/)
  flow        -- convex min-cost flow + residue cycles    (ref: rustflow crate)
  hashdbg     -- k-mer counting / draft DBG               (ref: src/hashdbg.rs)
  multi_dbg   -- multi-k DBG + Bayesian inference         (ref: src/multi_dbg.rs)
  phmm        -- PHMM params/model/sampling               (ref: src/hmmv2/)
  ops         -- JAX/Pallas device kernels                (ref: src/hmmv2/{forward,backward}.rs)
  parallel    -- mesh/sharding for multi-chip scale-out   (ref: rayon fan-outs)
"""

__version__ = "0.1.0"

from . import prob  # noqa: F401
