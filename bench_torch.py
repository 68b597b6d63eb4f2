#!/usr/bin/env python3
"""North-star benchmark of the PyTorch port, beside the JAX package's
bench.py: forward+backward rays/s of the flagship (cloud_volume(256, 7) at
1920x1080) through the CUDA sweep kernels, with bench.py's gradient check,
the general sweep and bfloat16 beside it and the early-exit rates; one JSON
line last on stdout (volumetricrenderer_tpu_torch/bench.py).

    python3 bench_torch.py [--device cuda|cpu] [--runs 12] [--warmup 2]
"""
import sys

from volumetricrenderer_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
