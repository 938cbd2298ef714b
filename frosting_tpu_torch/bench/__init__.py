"""The port's measurement entry points, on a CUDA card:

    python -m frosting_tpu_torch.bench                      # bench.py's 512x512 @ 100k
    python -m frosting_tpu_torch.bench.bench_1080p          # 1920x1080 @ 1M
    python -m frosting_tpu_torch.bench.perf_vpu_dtype       # kernels P1, P2
    python -m frosting_tpu_torch.bench.perf_scan_variants   # kernels P3, P4

Each is the port of the JAX package's script of the same name; none reads
or writes a ``BENCH_*.json`` (those hold the JAX package's TPU numbers).
"""
