#!/bin/bash
# Build and run tools/gemm_bench.cu on a machine with an H100 and the CUDA
# toolkit: bash tools/gemm_bench.sh [reps]
set -e
here="$(cd "$(dirname "$0")" && pwd)"
csrc="$here/../src/repro_torch/kernels/csrc"
out="$here/../build/gemm_bench"
mkdir -p "$out"
nvcc="$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)"
"$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I "$csrc" \
    "$here/gemm_bench.cu" -o "$out/gemm_bench"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"$out/gemm_bench" "${1:-50}"
