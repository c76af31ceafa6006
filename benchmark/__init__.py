"""The benchmark of `hsenet_torch`, the PyTorch and CUDA port, on one NVIDIA
H100: its training steps, measured end to end and layer by layer.

    python -m benchmark.run --workload clip-s1-b24 --seed 7 --seconds 30 --trace 0

`BENCHMARK.json` at the repository's root names the cells; the harness
finds everything else by name under this folder:

  * `configs/<config>.json`: a model configuration as it is run (`family`
    names the program driver in `families/` and the plain reference in
    `reference/`);
  * `workloads/<traffic>.json`: a traffic mix, the parameters of the one
    generator in `traffic.py`;
  * `limits/<cell>.json`: the limits of the cell's correctness check;
  * `metrics/<metric>.py`: the reader of one per-layer metric.

The yardstick lives here and nowhere else: the traffic generator, the
weights (`weights.py`), the operation counts and the kernel bounds
(`flops.py`, `roofline.py`), the reduction of the profiler's trace
(`trace.py`), the plain references and the comparison that decides
`correct` (`check.py`). From the program the harness takes only the
system under test. Nothing here imports JAX or the JAX package.
"""
