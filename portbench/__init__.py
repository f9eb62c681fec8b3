"""The benchmark of the PyTorch/CUDA port: one entry point
(``portbench/run.py``), cells found by name in ``BENCHMARK.json``."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (set before torch is imported)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
