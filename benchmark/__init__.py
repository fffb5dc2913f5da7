"""The benchmark of `ralf_tpu_torch`, the PyTorch and CUDA port: one cell of
`BENCHMARK.json` a run (`python3 benchmark/run.py --workload <cell> ...`).

Everything that decides a number lives here and not in the program: the
traffic generator, the seeded weights and data, the plain references that
decide `correct`, the peaks and the kernels' operation and byte counts
(`costs/`), and the readers of the per-layer metrics (`metrics/`).  A cell
is found by name: its configuration in `configs/<config>.json`, its traffic
mix in `traffic/<mix>.json`, the window loop in `loops/<kind>.py`, the model
family's adapter in `families/<family>.py` (its training step's in
`families/<family>_train.py`) and each per-layer metric in
`metrics/<metric>.py`.  Nothing here imports JAX or the JAX package.
"""
