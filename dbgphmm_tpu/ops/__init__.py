"""Device kernels (JAX/XLA/Pallas) for the PHMM forward/backward DP.

Design (cf. SURVEY.md section 7):

* The graph's transition structure is a padded gather table ``[n, D]``
  (D = max degree, 5 for DBGs) — the "sparse matvec" of one DP step is a
  fixed-shape gather + logsumexp, batched over reads, vmapped over candidate
  copy-number assignments.
* The scan over read positions is ``jax.lax.scan`` (the recursion is
  inherently serial in the position axis).
* f32 tables with per-step renormalization (max-subtraction) + Kahan
  compensated offset accumulation keep f32 exact enough; f64 without
  renormalization is used on CPU for parity oracles.
"""

from .forward import (  # noqa: F401
    DeviceModel,
    backward_tables,
    forward_scores,
    forward_tables,
    full_prob_backward,
    node_freqs_and_mappings,
    pad_reads,
    to_device,
)
