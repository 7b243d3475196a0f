"""The benchmark of `spectrogram_tpu_torch`, the PyTorch and CUDA port:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once on the CUDA card and prints the
result as its last line.  See `portbench/harness.py` for the layout."""
