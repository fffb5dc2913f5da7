"""ralf_tpu_torch: RALF's sample paths (every task, the relation decode,
the `autoreg` family) in PyTorch, with CUDA kernels written by hand for the
NVIDIA H100 (sm_90a).

The JAX package `ralf_tpu` beside it is the reference; this package imports
none of it.  Sub-packages mirror it: core/, models/, ops/, retrieval/,
data/, eval/, utils/.  Entry points run on the card unless the caller passes
device="cpu", where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
