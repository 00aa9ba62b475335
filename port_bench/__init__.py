"""The benchmark of massive_marl_tpu_torch, the PyTorch and CUDA port, on
NVIDIA H100 cards (BENCHMARK.json at the repository's root names its
cells and metrics).

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m port_bench.calibrate --workload <cell> --seeds ... --control-seeds ...
    python -m pytest -p no:cacheprovider port_bench/tests            # CPU
    python -m pytest -p no:cacheprovider -m cuda port_bench/tests    # on a card

Nothing here imports JAX or the JAX package; reference/ imports nothing of
the port.
"""
