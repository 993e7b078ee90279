"""Roofline of a step on one card or a host of cards (port of
`repro/launch/roofline.py`'s `Roofline`).

Three terms per (arch x shape x cards), over a `Chip` record of the card's
published peaks:

  compute_s    = FLOPs / (chips * chip.peak_flops)          bf16 dense peak
  memory_s     = HBM bytes / (chips * chip.hbm_bw)          device memory
  collective_s = collective bytes / (chips * chip.link_bw)  NVLink, each way

The collective term holds only inside one NVLink host (up to 8 cards, all
to all); across hosts the network is slower and the term would be too low.

The FLOP term is `model_flops` of the port (`models/model.py`) and the byte
term `memory_model.memory_bytes`, both analytic.  The reference also parses
the compiled HLO of its sharded dry run for FLOPs, bytes and collectives
(`parse_hlo_costs`, `scan_corrected`); their counterpart, a FLOP count of
the port's own step, comes with the sharded dry run (ROADMAP.md queue 1
item 7).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """Published peaks of one card."""
    name: str
    peak_flops: float       # bf16 dense, FLOP/s
    hbm_bw: float           # device memory, bytes/s
    hbm_bytes: float        # device memory, bytes
    link_bw: float          # card-to-card, bytes/s each way


# NVIDIA H100 SXM data sheet: dense bf16, HBM3, NVLink 4 (900 GB/s a card
# to the rest of its host, 450 GB/s each way).  The rates assume the full
# 700 W power limit.
H100 = Chip(name="NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
            hbm_bytes=80e9, link_bw=450e9)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int
    model_flops: float
    chip: Chip = H100

    @property
    def compute_s(self):
        return self.flops / (self.chips * self.chip.peak_flops)

    @property
    def memory_s(self):
        return self.bytes_hbm / (self.chips * self.chip.hbm_bw)

    @property
    def collective_s(self):
        return self.bytes_collective / (self.chips * self.chip.link_bw)

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self):
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self):
        """Fraction of the chips' peak the step achieves, assuming perfect
        overlap (model-FLOPs time / bounding-term time)."""
        return self.fraction_at(self.step_s)

    def fraction_at(self, step_s: float) -> float:
        """The model-FLOPs share of the chips' peak of a step that takes
        `step_s` (a measured step: its model_flops / (step x peak))."""
        ideal = self.model_flops / (self.chips * self.chip.peak_flops)
        return ideal / max(step_s, 1e-12)

    def as_dict(self):
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective, "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
