"""The host-side plans of the product kernels (kernels.gemm_plan,
kernels.linear_plan, grad_weight's row chunks), on the CPU: each class the
card tests and the recorded runs use gets a route the C entry points
accept (csrc/grad.cu operand_map, csrc/linear.cu launch_linear), a TMA
route wherever TMA's rule allows one, and a tile the kernels are built
for."""

import pytest
import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernel_checks import (gemm_kernel_cases,
                                             linear_kernel_cases)

SMS = 132            # the H100's SMs
BASE = 1 << 21       # a 2 MB aligned allocation, as the card's allocator gives

# (M, N, K, nb, A dtype, B dtype, layout, split): the gemm classes that
# chip_smoke.py's recorder met on the card (stock, standalone-attention,
# eval, coco17 and every backbone's and the multi-scale steps); layout:
# A k- or m-contiguous, B k- or n-contiguous
GEMM_RECORDED = [
    (21, 48, 1045, (8, 4), 'bf16', 'bf16', 'kn', False), (21, 48, 1045, (8, 6), 'bf16', 'bf16', 'kn', False),
    (21, 48, 1045, (8, 8), 'bf16', 'bf16', 'kn', False), (21, 48, 1045, (8, 16), 'bf16', 'bf16', 'kn', False),
    (21, 48, 1301, (8, 4), 'bf16', 'bf16', 'kn', False), (21, 48, 1621, (8, 4), 'bf16', 'bf16', 'kn', False),
    (21, 1045, 48, (8, 4), 'bf16', 'bf16', 'kk', False), (21, 1045, 48, (8, 4), 'f32', 'bf16', 'kk', False),
    (21, 1045, 48, (8, 6), 'f32', 'bf16', 'kk', False), (21, 1045, 48, (8, 8), 'f32', 'bf16', 'kk', False),
    (21, 1045, 48, (8, 16), 'f32', 'bf16', 'kk', False), (21, 1301, 48, (8, 4), 'f32', 'bf16', 'kk', False),
    (21, 1621, 48, (8, 4), 'f32', 'bf16', 'kk', False), (91, 48, 1115, (8, 4), 'bf16', 'bf16', 'kn', False),
    (91, 1115, 48, (8, 4), 'f32', 'bf16', 'kk', False), (168, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 192, 768, (1, 1), 'f32', 'bf16', 'kn', False), (168, 288, 288, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 288, 1152, (1, 1), 'f32', 'bf16', 'kn', False), (168, 384, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 384, 1536, (1, 1), 'f32', 'bf16', 'kn', False), (168, 768, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 768, 768, (1, 1), 'f32', 'bf16', 'kn', False), (168, 768, 3072, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 1152, 288, (1, 1), 'f32', 'bf16', 'kn', False), (168, 1536, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (168, 3072, 768, (1, 1), 'f32', 'bf16', 'kn', False), (192, 192, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (192, 192, 364, (2, 1), 'f32', 'bf16', 'mn', True), (192, 192, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (192, 192, 480, (10, 1), 'f32', 'f32', 'mn', True), (192, 192, 512, (16, 1), 'f32', 'bf16', 'mn', True),
    (192, 192, 512, (20, 1), 'f32', 'bf16', 'mn', True), (192, 192, 512, (25, 1), 'f32', 'bf16', 'mn', True),
    (192, 768, 168, (1, 1), 'f32', 'bf16', 'mn', True), (192, 768, 364, (2, 1), 'f32', 'bf16', 'mn', True),
    (192, 768, 512, (16, 1), 'f32', 'bf16', 'mn', True), (192, 768, 512, (20, 1), 'f32', 'bf16', 'mn', True),
    (192, 768, 512, (25, 1), 'f32', 'bf16', 'mn', True), (192, 2048, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (192, 2048, 512, (16, 1), 'f32', 'bf16', 'mn', True), (192, 2048, 512, (20, 1), 'f32', 'bf16', 'mn', True),
    (192, 2048, 512, (25, 1), 'f32', 'bf16', 'mn', True), (288, 288, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (288, 288, 480, (10, 1), 'f32', 'bf16', 'mn', True), (288, 288, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (288, 288, 512, (16, 1), 'f32', 'bf16', 'mn', True), (288, 1152, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (288, 1152, 512, (16, 1), 'f32', 'bf16', 'mn', True), (288, 2048, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (288, 2048, 512, (16, 1), 'f32', 'bf16', 'mn', True), (300, 24, 300, (16, 8), 'bf16', 'bf16', 'kn', False),
    (300, 24, 300, (16, 8), 'bf16', 'bf16', 'mn', False), (300, 24, 300, (16, 8), 'bf16', 'f32', 'mn', False),
    (300, 36, 300, (16, 8), 'bf16', 'bf16', 'kn', False), (300, 36, 300, (16, 8), 'bf16', 'bf16', 'mn', False),
    (300, 36, 300, (16, 8), 'bf16', 'f32', 'mn', False), (300, 48, 300, (16, 8), 'bf16', 'bf16', 'kn', False),
    (300, 48, 300, (16, 8), 'bf16', 'bf16', 'mn', False), (300, 48, 300, (16, 8), 'bf16', 'f32', 'mn', False),
    (300, 96, 300, (16, 8), 'bf16', 'bf16', 'kn', False), (300, 96, 300, (16, 8), 'bf16', 'bf16', 'mn', False),
    (300, 96, 300, (16, 8), 'bf16', 'f32', 'mn', False), (300, 300, 24, (16, 8), 'bf16', 'bf16', 'kk', False),
    (300, 300, 24, (16, 8), 'f32', 'bf16', 'kk', False), (300, 300, 36, (16, 8), 'bf16', 'bf16', 'kk', False),
    (300, 300, 36, (16, 8), 'f32', 'bf16', 'kk', False), (300, 300, 48, (16, 8), 'bf16', 'bf16', 'kk', False),
    (300, 300, 48, (16, 8), 'f32', 'bf16', 'kk', False), (300, 300, 96, (16, 8), 'bf16', 'bf16', 'kk', False),
    (300, 300, 96, (16, 8), 'f32', 'bf16', 'kk', False), (384, 192, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (384, 192, 512, (16, 1), 'f32', 'bf16', 'mn', True), (384, 192, 512, (20, 1), 'f32', 'bf16', 'mn', True),
    (384, 192, 512, (25, 1), 'f32', 'bf16', 'mn', True), (384, 384, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (384, 384, 480, (10, 1), 'f32', 'bf16', 'mn', True), (384, 384, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (384, 384, 512, (16, 1), 'f32', 'bf16', 'mn', True), (384, 1536, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (384, 1536, 512, (16, 1), 'f32', 'bf16', 'mn', True), (384, 2048, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (384, 2048, 512, (16, 1), 'f32', 'bf16', 'mn', True), (576, 192, 492, (17, 1), 'f32', 'bf16', 'mn', True),
    (576, 192, 496, (18, 1), 'f32', 'bf16', 'mn', True), (576, 192, 496, (21, 1), 'f32', 'bf16', 'mn', True),
    (576, 192, 499, (26, 1), 'f32', 'bf16', 'mn', True), (576, 192, 512, (16, 1), 'f32', 'bf16', 'mn', True),
    (576, 192, 512, (20, 1), 'f32', 'bf16', 'mn', True), (576, 192, 512, (25, 1), 'f32', 'bf16', 'mn', True),
    (576, 288, 480, (10, 1), 'f32', 'bf16', 'mn', True), (576, 288, 512, (16, 1), 'f32', 'bf16', 'mn', True),
    (600, 48, 1024, (8, 8), 'bf16', 'bf16', 'kn', False), (600, 48, 1280, (8, 8), 'bf16', 'bf16', 'kn', False),
    (600, 48, 1600, (8, 8), 'bf16', 'bf16', 'kn', False), (600, 72, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (600, 96, 1024, (8, 8), 'bf16', 'bf16', 'kn', False), (600, 192, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (600, 1024, 24, (8, 8), 'bf16', 'bf16', 'kk', False), (600, 1024, 24, (8, 8), 'f32', 'bf16', 'kk', False),
    (600, 1024, 36, (8, 8), 'f32', 'bf16', 'kk', False), (600, 1024, 48, (8, 8), 'bf16', 'bf16', 'kk', False),
    (600, 1024, 48, (8, 8), 'f32', 'bf16', 'kk', False), (600, 1024, 72, (8, 8), 'bf16', 'bf16', 'kk', False),
    (600, 1024, 96, (8, 8), 'bf16', 'bf16', 'kk', False), (600, 1024, 96, (8, 8), 'f32', 'bf16', 'kk', False),
    (600, 1024, 192, (8, 8), 'bf16', 'bf16', 'kk', False), (600, 1280, 24, (8, 8), 'f32', 'bf16', 'kk', False),
    (600, 1280, 48, (8, 8), 'bf16', 'bf16', 'kk', False), (600, 1600, 24, (8, 8), 'f32', 'bf16', 'kk', False),
    (600, 1600, 48, (8, 8), 'bf16', 'bf16', 'kk', False), (728, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (728, 192, 768, (1, 1), 'f32', 'bf16', 'kn', False), (728, 768, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (768, 192, 168, (1, 1), 'f32', 'bf16', 'mn', True), (768, 192, 364, (2, 1), 'f32', 'bf16', 'mn', True),
    (768, 192, 512, (16, 1), 'f32', 'bf16', 'mn', True), (768, 192, 512, (20, 1), 'f32', 'bf16', 'mn', True),
    (768, 192, 512, (25, 1), 'f32', 'bf16', 'mn', True), (768, 384, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (768, 384, 512, (16, 1), 'f32', 'bf16', 'mn', True), (768, 768, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (768, 768, 480, (10, 1), 'f32', 'bf16', 'mn', True), (768, 768, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (768, 768, 512, (16, 1), 'f32', 'bf16', 'mn', True), (768, 2048, 480, (10, 1), 'f32', 'bf16', 'mn', True),
    (768, 2048, 512, (16, 1), 'f32', 'bf16', 'mn', True), (768, 3072, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (768, 3072, 512, (16, 1), 'f32', 'bf16', 'mn', True), (864, 288, 492, (17, 1), 'f32', 'bf16', 'mn', True),
    (864, 288, 512, (16, 1), 'f32', 'bf16', 'mn', True), (1024, 24, 600, (8, 8), 'bf16', 'bf16', 'mn', False),
    (1024, 24, 600, (8, 8), 'bf16', 'f32', 'mn', False), (1024, 24, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1024, 24, 1024, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 24, 1024, (8, 8), 'bf16', 'f32', 'mn', False),
    (1024, 36, 600, (8, 8), 'bf16', 'f32', 'mn', False), (1024, 36, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1024, 36, 1024, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 36, 1024, (8, 8), 'bf16', 'f32', 'mn', False),
    (1024, 48, 600, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 48, 600, (8, 8), 'bf16', 'f32', 'mn', False),
    (1024, 48, 1024, (8, 4), 'bf16', 'bf16', 'kn', False), (1024, 48, 1024, (8, 4), 'bf16', 'bf16', 'mn', False),
    (1024, 48, 1024, (8, 4), 'bf16', 'f32', 'mn', False), (1024, 48, 1024, (8, 6), 'bf16', 'bf16', 'kn', False),
    (1024, 48, 1024, (8, 6), 'bf16', 'f32', 'mn', False), (1024, 48, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1024, 48, 1024, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 48, 1024, (8, 8), 'bf16', 'f32', 'mn', False),
    (1024, 48, 1024, (8, 16), 'bf16', 'bf16', 'kn', False), (1024, 48, 1024, (8, 16), 'bf16', 'f32', 'mn', False),
    (1024, 72, 600, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 96, 600, (8, 8), 'bf16', 'bf16', 'mn', False),
    (1024, 96, 600, (8, 8), 'bf16', 'f32', 'mn', False), (1024, 96, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1024, 96, 1024, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 96, 1024, (8, 8), 'bf16', 'f32', 'mn', False),
    (1024, 192, 600, (8, 8), 'bf16', 'bf16', 'mn', False), (1024, 192, 1024, (8, 4), 'bf16', 'bf16', 'kn', False),
    (1024, 192, 4096, (8, 1), 'bf16', 'bf16', 'mn', False), (1024, 288, 1024, (8, 6), 'bf16', 'bf16', 'kn', False),
    (1024, 288, 6144, (8, 1), 'bf16', 'bf16', 'mn', False), (1024, 384, 1024, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1024, 384, 8192, (8, 1), 'bf16', 'bf16', 'mn', False), (1024, 768, 1024, (8, 16), 'bf16', 'bf16', 'kn', False),
    (1024, 768, 16384, (8, 1), 'bf16', 'bf16', 'mn', False), (1024, 1024, 24, (8, 8), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 24, (8, 8), 'f32', 'bf16', 'kk', False), (1024, 1024, 36, (8, 8), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 36, (8, 8), 'f32', 'bf16', 'kk', False), (1024, 1024, 48, (8, 4), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 48, (8, 4), 'f32', 'bf16', 'kk', False), (1024, 1024, 48, (8, 6), 'f32', 'bf16', 'kk', False),
    (1024, 1024, 48, (8, 8), 'bf16', 'bf16', 'kk', False), (1024, 1024, 48, (8, 8), 'f32', 'bf16', 'kk', False),
    (1024, 1024, 48, (8, 16), 'f32', 'bf16', 'kk', False), (1024, 1024, 96, (8, 8), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 96, (8, 8), 'f32', 'bf16', 'kk', False), (1024, 1024, 192, (8, 4), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 288, (8, 6), 'bf16', 'bf16', 'kk', False), (1024, 1024, 384, (8, 8), 'bf16', 'bf16', 'kk', False),
    (1024, 1024, 768, (8, 16), 'bf16', 'bf16', 'kk', False), (1045, 48, 21, (8, 4), 'bf16', 'bf16', 'mn', False),
    (1045, 48, 21, (8, 4), 'f32', 'f32', 'mn', False), (1045, 48, 21, (8, 6), 'bf16', 'bf16', 'mn', False),
    (1045, 48, 21, (8, 6), 'f32', 'f32', 'mn', False), (1045, 48, 21, (8, 8), 'bf16', 'bf16', 'mn', False),
    (1045, 48, 21, (8, 8), 'f32', 'f32', 'mn', False), (1045, 48, 21, (8, 16), 'bf16', 'bf16', 'mn', False),
    (1045, 48, 21, (8, 16), 'f32', 'f32', 'mn', False), (1115, 48, 91, (8, 4), 'bf16', 'bf16', 'mn', False),
    (1115, 48, 91, (8, 4), 'f32', 'f32', 'mn', False), (1152, 288, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (1152, 288, 512, (16, 1), 'f32', 'bf16', 'mn', True), (1152, 384, 492, (17, 1), 'f32', 'bf16', 'mn', True),
    (1152, 384, 512, (16, 1), 'f32', 'bf16', 'mn', True), (1280, 24, 600, (8, 8), 'bf16', 'f32', 'mn', False),
    (1280, 24, 1280, (8, 8), 'bf16', 'bf16', 'kn', False), (1280, 24, 1280, (8, 8), 'bf16', 'bf16', 'mn', False),
    (1280, 24, 1280, (8, 8), 'bf16', 'f32', 'mn', False), (1280, 48, 600, (8, 8), 'bf16', 'bf16', 'mn', False),
    (1280, 48, 1280, (8, 4), 'bf16', 'bf16', 'kn', False), (1280, 48, 1280, (8, 4), 'bf16', 'f32', 'mn', False),
    (1280, 192, 1280, (8, 4), 'bf16', 'bf16', 'kn', False), (1280, 192, 5120, (8, 1), 'bf16', 'bf16', 'mn', False),
    (1280, 1280, 24, (8, 8), 'bf16', 'bf16', 'kk', False), (1280, 1280, 24, (8, 8), 'f32', 'bf16', 'kk', False),
    (1280, 1280, 48, (8, 4), 'f32', 'bf16', 'kk', False), (1280, 1280, 192, (8, 4), 'bf16', 'bf16', 'kk', False),
    (1301, 48, 21, (8, 4), 'bf16', 'bf16', 'mn', False), (1301, 48, 21, (8, 4), 'f32', 'f32', 'mn', False),
    (1536, 384, 168, (1, 1), 'f32', 'bf16', 'mn', True), (1536, 384, 512, (16, 1), 'f32', 'bf16', 'mn', True),
    (1536, 768, 480, (10, 1), 'f32', 'bf16', 'mn', True), (1536, 768, 512, (16, 1), 'f32', 'bf16', 'mn', True),
    (1600, 24, 600, (8, 8), 'bf16', 'f32', 'mn', False), (1600, 24, 1600, (8, 8), 'bf16', 'bf16', 'kn', False),
    (1600, 24, 1600, (8, 8), 'bf16', 'bf16', 'mn', False), (1600, 24, 1600, (8, 8), 'bf16', 'f32', 'mn', False),
    (1600, 48, 600, (8, 8), 'bf16', 'bf16', 'mn', False), (1600, 48, 1600, (8, 4), 'bf16', 'bf16', 'kn', False),
    (1600, 48, 1600, (8, 4), 'bf16', 'f32', 'mn', False), (1600, 192, 1600, (8, 4), 'bf16', 'bf16', 'kn', False),
    (1600, 192, 6400, (8, 1), 'bf16', 'bf16', 'mn', False), (1600, 1600, 24, (8, 8), 'bf16', 'bf16', 'kk', False),
    (1600, 1600, 24, (8, 8), 'f32', 'bf16', 'kk', False), (1600, 1600, 48, (8, 4), 'f32', 'bf16', 'kk', False),
    (1600, 1600, 192, (8, 4), 'bf16', 'bf16', 'kk', False), (1621, 48, 21, (8, 4), 'bf16', 'bf16', 'mn', False),
    (1621, 48, 21, (8, 4), 'f32', 'f32', 'mn', False), (2048, 192, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (2048, 192, 512, (16, 1), 'f32', 'f32', 'mn', True), (2048, 192, 512, (20, 1), 'f32', 'f32', 'mn', True),
    (2048, 192, 512, (25, 1), 'f32', 'f32', 'mn', True), (2048, 288, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (2048, 288, 512, (16, 1), 'f32', 'f32', 'mn', True), (2048, 384, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (2048, 384, 512, (16, 1), 'f32', 'f32', 'mn', True), (2048, 768, 480, (10, 1), 'f32', 'f32', 'mn', True),
    (2048, 768, 512, (16, 1), 'f32', 'f32', 'mn', True), (2304, 768, 492, (17, 1), 'f32', 'bf16', 'mn', True),
    (2304, 768, 512, (16, 1), 'f32', 'bf16', 'mn', True), (3072, 768, 168, (1, 1), 'f32', 'bf16', 'mn', True),
    (3072, 768, 512, (16, 1), 'f32', 'bf16', 'mn', True), (4800, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 192, 384, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 192, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 288, 288, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 288, 576, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 288, 864, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 288, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 384, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 384, 768, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 384, 1152, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 384, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 768, 768, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 768, 1536, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 768, 2048, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 768, 2304, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 2048, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 2048, 288, (1, 1), 'f32', 'bf16', 'kn', False), (4800, 2048, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (4800, 2048, 768, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 192, 384, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 192, 768, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 192, 2048, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 288, 288, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 288, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 288, 864, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 288, 1152, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 288, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 384, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 384, 768, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 384, 1152, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 384, 1536, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 384, 2048, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 768, 192, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 768, 768, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 768, 1536, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 768, 2048, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 768, 2304, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 768, 3072, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 1152, 288, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 1536, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 2048, 192, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 2048, 288, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 2048, 384, (1, 1), 'f32', 'bf16', 'kn', False), (8192, 2048, 768, (1, 1), 'f32', 'bf16', 'kn', False),
    (8192, 3072, 768, (1, 1), 'f32', 'bf16', 'kn', False), (8360, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (8360, 288, 864, (1, 1), 'f32', 'bf16', 'kn', False), (8360, 384, 1152, (1, 1), 'f32', 'bf16', 'kn', False),
    (8360, 768, 2304, (1, 1), 'f32', 'bf16', 'kn', False), (8920, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (10240, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False), (10240, 192, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (10240, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False), (10240, 192, 768, (1, 1), 'f32', 'bf16', 'kn', False),
    (10240, 192, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (10240, 768, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (10240, 2048, 192, (1, 1), 'f32', 'bf16', 'kn', False), (10408, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
    (12800, 192, 192, (1, 1), 'f32', 'bf16', 'kn', False), (12800, 192, 384, (1, 1), 'f32', 'bf16', 'kn', False),
    (12800, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False), (12800, 192, 768, (1, 1), 'f32', 'bf16', 'kn', False),
    (12800, 192, 2048, (1, 1), 'f32', 'bf16', 'kn', False), (12800, 768, 192, (1, 1), 'f32', 'bf16', 'kn', False),
    (12800, 2048, 192, (1, 1), 'f32', 'bf16', 'kn', False), (12968, 192, 576, (1, 1), 'f32', 'bf16', 'kn', False),
]

# (M, N, K, plain A): the linear classes of the same runs
LINEAR_RECORDED = [
    (168, 192, 192, True), (168, 192, 768, True), (168, 288, 288, True), (168, 288, 1152, True),
    (168, 384, 384, True), (168, 384, 1536, True), (168, 768, 192, False), (168, 768, 192, True),
    (168, 768, 768, True), (168, 768, 3072, True), (168, 1152, 288, False), (168, 1152, 288, True),
    (168, 1536, 384, False), (168, 1536, 384, True), (168, 3072, 768, False), (168, 3072, 768, True),
    (336, 192, 192, True), (336, 192, 768, True), (336, 768, 192, False), (728, 192, 192, True),
    (728, 192, 768, True), (728, 768, 192, False), (728, 768, 192, True), (4800, 192, 192, False),
    (4800, 192, 192, True), (4800, 192, 2048, True), (4800, 288, 288, False), (4800, 288, 288, True),
    (4800, 288, 2048, True), (4800, 384, 192, True), (4800, 384, 384, False), (4800, 384, 384, True),
    (4800, 384, 2048, True), (4800, 576, 288, True), (4800, 768, 384, True), (4800, 768, 768, False),
    (4800, 768, 768, True), (4800, 768, 2048, True), (4800, 1536, 768, True), (4800, 2048, 192, False),
    (4800, 2048, 288, False), (4800, 2048, 384, False), (4800, 2048, 768, False), (8192, 192, 192, True),
    (8192, 192, 768, True), (8192, 192, 2048, True), (8192, 288, 288, True), (8192, 288, 1152, True),
    (8192, 288, 2048, True), (8192, 384, 192, False), (8192, 384, 384, True), (8192, 384, 1536, True),
    (8192, 384, 2048, True), (8192, 576, 192, False), (8192, 576, 192, True), (8192, 576, 288, False),
    (8192, 768, 192, False), (8192, 768, 192, True), (8192, 768, 384, False), (8192, 768, 768, True),
    (8192, 768, 2048, True), (8192, 768, 3072, True), (8192, 864, 288, False), (8192, 864, 288, True),
    (8192, 1152, 288, False), (8192, 1152, 288, True), (8192, 1152, 384, False), (8192, 1152, 384, True),
    (8192, 1536, 384, False), (8192, 1536, 384, True), (8192, 1536, 768, False), (8192, 2048, 192, False),
    (8192, 2048, 288, False), (8192, 2048, 384, False), (8192, 2048, 768, False), (8192, 2304, 768, False),
    (8192, 2304, 768, True), (8192, 3072, 768, False), (8192, 3072, 768, True), (8360, 576, 192, False),
    (8360, 576, 192, True), (8360, 864, 288, False), (8360, 864, 288, True), (8360, 1152, 384, False),
    (8360, 1152, 384, True), (8360, 2304, 768, False), (8360, 2304, 768, True), (8920, 576, 192, False),
    (8920, 576, 192, True), (9600, 192, 192, False), (9600, 192, 192, True), (9600, 192, 2048, True),
    (9600, 384, 192, True), (9600, 2048, 192, False), (10240, 192, 192, True), (10240, 192, 768, True),
    (10240, 192, 2048, True), (10240, 384, 192, False), (10240, 576, 192, False), (10240, 576, 192, True),
    (10240, 768, 192, False), (10240, 768, 192, True), (10240, 2048, 192, False), (10408, 576, 192, False),
    (10408, 576, 192, True), (12800, 192, 192, True), (12800, 192, 768, True), (12800, 192, 2048, True),
    (12800, 384, 192, False), (12800, 576, 192, False), (12800, 576, 192, True), (12800, 768, 192, False),
    (12800, 768, 192, True), (12800, 2048, 192, False), (12968, 576, 192, False), (12968, 576, 192, True),
    (16384, 192, 192, True), (16384, 192, 768, True), (16384, 192, 2048, True), (16384, 384, 192, False),
    (16384, 576, 192, False), (16384, 768, 192, False), (16384, 2048, 192, False), (16720, 576, 192, False),
]


def _rule(addr, es, cont, strides):
    """TMA's rule, restated from csrc/wgmma.cuh wg_host::encode: a unit
    stride along the contiguous index, a 16-byte aligned base, positive
    16-byte multiples below 2^40 for the listed strides."""
    return cont == 1 and addr % 16 == 0 and all(
        0 < s * es < 1 << 40 and s * es % 16 == 0 for s in strides)


def _accepted(M, N, Kd, nb, addr, f32, st, split, route, is_a):
    """Would operand_map accept this route for the operand?"""
    if route == K.ROUTE_REG:
        return True
    if (route == K.ROUTE_F32) != f32:
        return False
    s1, s2, x, y = st
    if is_a:
        km = not (x == 1 and y != 1)
        cont, row, ks = (y, x, y) if km else (x, y, y)
    else:
        km = y != 1
        cont, row, ks = (x, y, x) if km else (y, x, x)
    if split:
        if nb[1] != 1 or Kd % 64 or s1 != Kd * ks:
            return False
        batch = ()
    else:   # a batch dim of stride 0 (the operand shared) is not mapped
        batch = tuple(s for s, n in ((s2, nb[1]), (s1, nb[0]))
                      if n > 1 and s != 0)
    return _rule(addr, 4 if f32 else 2, cont, (row, *batch))


def _check_gemm(M, N, Kd, nb, a_addr, a_f32, a_str, b_addr, b_f32, b_str,
                split):
    tile, ra, rb = K.gemm_plan(M, N, Kd, nb, a_addr, a_f32, a_str, b_addr,
                               b_f32, b_str, split, SMS)
    assert tile in (K.GEMM_LARGE, K.GEMM_SMALL)
    if tile == K.GEMM_LARGE:
        assert M > 64 and N > 64
    for addr, f32, st, route, is_a in ((a_addr, a_f32, a_str, ra, True),
                                       (b_addr, b_f32, b_str, rb, False)):
        assert _accepted(M, N, Kd, nb, addr, f32, st, split, route, is_a)
        # TMA wherever the rule allows it
        best = K.ROUTE_F32 if f32 else K.ROUTE_TMA
        assert route == best or not _accepted(M, N, Kd, nb, addr, f32, st,
                                              split, best, is_a)
    return tile, ra, rb


GEMM_CASES = gemm_kernel_cases(device="cpu")


def _addr(t):
    return BASE + t.storage_offset() * t.element_size()


@pytest.mark.parametrize("case", range(len(GEMM_CASES)),
                         ids=[label for label, _ in GEMM_CASES])
def test_gemm_plan_of_card_cases(case):
    """Every card test's gemm gets routes operand_map accepts: the
    misaligned and strided views take REG, the rest TMA or F32."""
    label, c = GEMM_CASES[case]
    kw, a, b = c["kw"], c["a"], c["b"]
    _, ra, rb = _check_gemm(kw["M"], kw["N"], kw["K"], kw["nb"], _addr(a),
                            a.dtype == torch.float32, kw["a_str"], _addr(b),
                            b.dtype == torch.float32, kw["b_str"],
                            kw.get("split_k") is not None)
    if "misaligned" in label or "no unit stride" in label:
        assert K.ROUTE_REG in (ra, rb)


def _recorded_layouts(M, N, Kd, nb, lay):
    """The strides the port hands gemm for a class: planes laid out
    contiguously, (the per-head products) heads interleaved in rows of nb2
    heads, and B shared across the heads (a z2 stride of 0: the talking
    heads' folded products)."""
    n1, n2 = nb
    a_km, b_km = lay[0] == "k", lay[1] == "k"
    out = []
    for heads in (False, True):
        def mat(R, C, row_major):
            # (s1, s2, s_row, s_col) of nb (R, C) matrices
            if heads:
                ld = n2 * (C if row_major else R)
                if row_major:
                    return (R * ld, C, ld, 1)
                return (C * ld, R, 1, ld)
            if row_major:
                return (n2 * R * C, R * C, C, 1)
            return (n2 * R * C, R * C, 1, R)
        out.append((mat(M, Kd, a_km), mat(Kd, N, not b_km)))
    a_str, b_str = out[0]
    out.append((a_str, (b_str[0], 0, *b_str[2:])))
    return out


@pytest.mark.parametrize("cls", GEMM_RECORDED, ids=str)
def test_gemm_plan_of_recorded_classes(cls):
    """Every recorded class, in both layouts the port uses for it, gets
    routes operand_map accepts; a weight gradient's chunks (grad_weight:
    multiples of 64 rows) and every class with 16-byte rows take TMA."""
    M, N, Kd, nb, adt, bdt, lay, split = cls
    a_f32, b_f32 = adt == "f32", bdt == "f32"
    if split:   # the chunks grad_weight now cuts from the same rows
        rows = Kd * nb[0]
        chunk = K.grad_weight_chunk(rows)
        Z = -(-rows // chunk)
        a_str, b_str = (chunk * M, 0, 1, M), (chunk * N, 0, N, 1)
        _, ra, rb = _check_gemm(M, N, chunk, (Z, 1), BASE, a_f32, a_str,
                                BASE, b_f32, b_str, True)
        assert ra != K.ROUTE_REG and rb != K.ROUTE_REG
        return
    for a_str, b_str in _recorded_layouts(M, N, Kd, nb, lay):
        _, ra, rb = _check_gemm(M, N, Kd, nb, BASE, a_f32, a_str, BASE,
                                b_f32, b_str, False)
        for route, st, f32 in ((ra, a_str, a_f32), (rb, b_str, b_f32)):
            es = 4 if f32 else 2
            if all(s * es % 16 == 0 for s in st if s):
                assert route != K.ROUTE_REG, (st, route)


LINEAR_CASES = linear_kernel_cases(device="cpu")


def _check_linear(M, N, Kd, plain, a_addr, lda, w_addr):
    tile, ra, rw = K.linear_plan(M, N, Kd, plain, a_addr, lda, w_addr, SMS)
    panel = tile in (K.PANEL_128, K.PANEL_64_128, K.PANEL_64)
    # spe_linear: a transformed A only through a panel, each panel tile
    # within its depth, the stream tiles for a plain A
    assert panel or plain
    assert tile != K.PANEL_128 or Kd <= K.WHOLE_KMAX
    assert tile != K.PANEL_64_128 or Kd <= K.PANEL_WIDE_KMAX
    assert not panel or Kd <= K.PANEL_KMAX
    if tile in (K.STREAM_128, K.STREAM_64):
        assert Kd > K.WHOLE_KMAX
    assert ra in (K.ROUTE_TMA, K.ROUTE_REG) and rw in (K.ROUTE_TMA,
                                                      K.ROUTE_REG)
    assert (ra == K.ROUTE_TMA) == (plain and _rule(a_addr, 2, 1, (lda,)))
    assert (rw == K.ROUTE_TMA) == _rule(w_addr, 2, 1, (Kd,))
    return tile, ra, rw


@pytest.mark.parametrize("case", range(len(LINEAR_CASES)),
                         ids=[label for label, _ in LINEAR_CASES])
def test_linear_plan_of_card_cases(case):
    """Every card test's ln_linear gets a tile and routes spe_linear
    accepts."""
    _, c = LINEAR_CASES[case]
    a, w, kw = c["a"], c["w"], c["kw"]
    plain = kw.get("ln") is None and kw.get("a2") is None and \
        a.dtype == torch.bfloat16
    _check_linear(a.shape[0], w.shape[0], a.shape[1], plain, _addr(a),
                  a.stride(0), _addr(w))


@pytest.mark.parametrize("cls", LINEAR_RECORDED, ids=str)
def test_linear_plan_of_recorded_classes(cls):
    """Every recorded linear class (contiguous rows, as the fused layers
    hand them) takes TMA for W, and for A where it is plain, and the
    panel for every K <= 256 and every transformed A."""
    M, N, Kd, plain = cls
    tile, ra, rw = _check_linear(M, N, Kd, plain, BASE, Kd, BASE)
    assert rw == K.ROUTE_TMA or Kd % 8
    assert (tile in (K.STREAM_128, K.STREAM_64)) == (plain and Kd > 256)


@pytest.mark.parametrize("rows", [1, 63, 64, 168, 336, 728, 2400, 4800,
                                  8192, 8920, 9600, 16384, 16720])
def test_grad_weight_chunks(rows):
    """grad_weight's row chunks: about ROW_CHUNK rows, a multiple of 64
    (so the split takes the TMA route), covering every row with none
    empty."""
    chunk = K.grad_weight_chunk(rows)
    Z = -(-rows // chunk)
    assert chunk % 64 == 0 and chunk <= K.ROW_CHUNK + 63
    assert (Z - 1) * chunk < rows <= Z * chunk
    assert Z == -(-rows // K.ROW_CHUNK) or rows < K.ROW_CHUNK
