"""Paper notation (Table 1) as a dataclass, so formulas read like the paper.

a: attention heads, b: micro batch size, h: hidden dim, l: layers,
s: sequence length, v: vocab, B: global batch, p: pipeline size,
t: tensor parallel size.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Notation:
    a: int   # attention heads
    b: int   # micro batch size
    h: int   # hidden dim
    l: int   # layers
    s: int   # sequence length
    v: int   # vocab size
    B: int   # global batch size
    p: int   # pipeline parallel size
    t: int   # tensor parallel size

    @property
    def num_micro(self) -> int:
        assert self.B % self.b == 0, (self.B, self.b)
        return self.B // self.b

    def replace(self, **kw) -> "Notation":
        return dataclasses.replace(self, **kw)


def from_model(cfg: ModelConfig, *, b=1, s=2048, B=128, p=8, t=4) -> Notation:
    return Notation(a=cfg.num_heads, b=b, h=cfg.d_model, l=cfg.num_layers,
                    s=s, v=cfg.vocab_size, B=B, p=p, t=t)


# Paper Table 2 rows.
GPT3_96B = Notation(a=104, b=1, h=9984, l=80, s=2048, v=51200, B=128, p=8, t=4)
LLAMA_65B = Notation(a=64, b=1, h=8192, l=80, s=2048, v=32000, B=128, p=8, t=4)

# Hardware constants. The paper ran A100s; our target is TPU v5e.
A100_PEAK_BF16 = 312e12
TPU_V5E_PEAK_BF16 = 197e12
TPU_V5E_HBM_BW = 819e9
TPU_V5E_ICI_BW = 50e9
TPU_V5E_HBM_BYTES = 16 * 1024**3
A100_HBM_BYTES = 80 * 1024**3
NVLINK_BW = 300e9  # effective per-direction A100 NVLink
PCIE_BW = 25e9     # effective per-direction PCIe gen4 x16 (host offload)
