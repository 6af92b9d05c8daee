"""CRONet configuration, reconstructed exactly from paper Table I.

A copy of ``repro.configs.cronet`` (the port imports nothing from ``repro``).

Reverse-engineering (all factorizations verified against Table I):

TrunkNet — input: load volume (B, 4, ny+1, nx+1, 1); depth-4 stack of
  [Fx, Fy, support_x, support_y] on the FEA nodal grid:
  Conv3D-1 k=(2,3,3) 1->16, same            params 288     (paper 288)
    MACs counted at depth-valid positions: 3*(ny+1)*(nx+1)*288
    -> 294K/562K/1.1M for the three sizes   (paper 294K/562K/1.1M)
  Conv3D-2 k=(1,3,3) 16->64, same           params 9216    (paper 9K)
    MACs 4*(ny+1)*(nx+1)*9216 -> 12.6M/24M/47.2M (paper 12.6M/24M/47.2M)
  AAP3D -> (3,5,5) x 64ch = 4800 features
  Linear 4800->40 (no bias)                 params 192000  (paper 192K)
  Linear 40->2560 (no bias)                 params 102400  (paper 102K)

BranchNet — input: density history (B, T=10, ny, nx, 1); the CNN is
  TIME-DISTRIBUTED over the 10 FEA warm-up iterations (this is what makes
  Table I conv MACs 10x the single-frame count):
  Conv2D-1 k=3 1->16, same (no bias)        params 144     (paper 144)
    MACs 10*ny*nx*144 -> 432K/864K/1.7M     (paper 432K/864K/1.7M)
  Conv2D-2 k=3 16->32, same (no bias)       params 4608    (paper 4.6K)
    MACs 10*ny*nx*4608 -> 13.8M/27.6M/55.3M (paper 13.8M/27.6M/55.3M)
  MaxPool2D 2x2
  AAP2D -> (1,1) x 32ch = 32 features
  RNN hidden 64, tanh, no bias              params 64*(32+64)=6144 (paper 6.1K)
    10 unrolled steps -> 61.4K MACs         (paper 61.4K)
  Linear 64->40 (no bias)                   params 2560    (paper 2.5K)
  Linear 40->2560 (no bias)                 params 102400  (paper 102K)

Combine: U = branch ⊙ trunk (element-wise Mul, p=2560), decoded to the
(ny+1, nx+1, 2) nodal displacement field by reshape(32,40,2)+resize
(decoder is an assumption — DESIGN.md §9).

Total params = 419,760 ≈ paper's 419K. SiLU after every conv/linear
(L1-fused); Tanh inside the RNN step.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CRONetConfig:
    name: str = "cronet-medium"
    nelx: int = 30                 # elements in x
    nely: int = 20                 # elements in y
    hist_len: int = 10             # FEA warm-up iterations fed to the RNN
    # branch
    b_c1: int = 16
    b_c2: int = 32
    b_pool: Tuple[int, int] = (1, 1)   # AAP2D target
    rnn_hidden: int = 64
    # trunk
    t_depth: int = 4               # Fx, Fy, support_x, support_y
    t_c1: int = 16
    t_c2: int = 64
    t_pool: Tuple[int, int, int] = (3, 5, 5)  # AAP3D target
    # shared
    mid: int = 40
    p: int = 2560                  # DeepONet latent / Mul width
    dtype: str = "bfloat16"

    @property
    def nodes(self) -> Tuple[int, int]:
        return (self.nely + 1, self.nelx + 1)

    @property
    def trunk_features(self) -> int:
        d, h, w = self.t_pool
        return d * h * w * self.t_c2

    @property
    def branch_features(self) -> int:
        h, w = self.b_pool
        return h * w * self.b_c2

    def param_count(self) -> int:
        c = self
        trunk = (2 * 3 * 3 * 1 * c.t_c1) + (1 * 3 * 3 * c.t_c1 * c.t_c2) \
            + c.trunk_features * c.mid + c.mid * c.p
        branch = (3 * 3 * 1 * c.b_c1) + (3 * 3 * c.b_c1 * c.b_c2) \
            + c.rnn_hidden * (c.branch_features + c.rnn_hidden) \
            + c.rnn_hidden * c.mid + c.mid * c.p
        return trunk + branch


SIZES = {
    "small": CRONetConfig(name="cronet-small", nelx=30, nely=10),
    "medium": CRONetConfig(name="cronet-medium", nelx=30, nely=20),
    "large": CRONetConfig(name="cronet-large", nelx=60, nely=20),
}


def get_cronet_config(size: str = "medium") -> CRONetConfig:
    if size in SIZES:
        return SIZES[size]
    raise KeyError(f"unknown CRONet size {size!r}; have {sorted(SIZES)}")
