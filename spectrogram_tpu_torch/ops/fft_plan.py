"""The FFT plan and the layout gates of the JAX package, in numpy alone.

The JAX package factors each padded FFT length N = n1 * n2 for its TPU
matrix unit (`spectrogram_tpu/ops/mxu_fft.py` `FftPlan`, `choose_factors`,
`make_plan`), and its opt-in layouts are gated on that plan
(`spectrogram_tpu/ops/pallas/stft_kernel.py`).  The port's kernels need no
plan, but two of its public layouts are defined by one: the transposed carry
`[S, 2, n1, C/n1]` of `transposed_carry` and `framing="tsplit"` stores
sample t*n1 + j1 at [j1, t], with n1 from this plan; and the knobs accept
and refuse what the JAX pipeline (on its Pallas chain) accepts and refuses.
Those modules import JAX, which the port may not, so it keeps this copy;
`tests/test_torch_tables.py` pins every function here against the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spectrogram_tpu_torch.config import SpectrogramConfig


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """A factorization N = n1 * n2 of the padded FFT length, with m =
    window / n1 nonzero stage-1 rows (`mxu_fft.py:43`)."""

    n: int          # padded FFT length
    n1: int         # inner factor; divides the window
    n2: int         # outer factor
    m: int          # window // n1

    @property
    def complex_macs(self) -> int:
        return self.n1 * self.n2 * self.m + self.n1 * self.n1 * self.n2


def choose_factors(n: int, window: int) -> Optional[tuple[int, int]]:
    """(n1, n2) with n1 * n2 = n, n1 | window, both <= 256, of least
    n1*n2*m + n1^2*n2 cost; ties keep the smaller n1 (`mxu_fft.py:61`)."""
    best = None
    for n1 in range(2, 257):
        if n % n1:
            continue
        n2 = n // n1
        if n2 > 256 or window % n1:
            continue
        m = window // n1
        cost = n1 * n2 * m + n1 * n1 * n2
        if best is None or cost < best[0]:
            best = (cost, n1, n2)
    if best is None:
        return None
    return best[1], best[2]


def make_plan(cfg: SpectrogramConfig) -> Optional[FftPlan]:
    """The geometry's plan, or None where no factorization exists."""
    factors = choose_factors(cfg.padded_size, cfg.window_size)
    if factors is None:
        return None
    n1, n2 = factors
    return FftPlan(n=cfg.padded_size, n1=n1, n2=n2, m=cfg.window_size // n1)


def plan_usable(cfg: SpectrogramConfig, plan: Optional[FftPlan]) -> bool:
    """The JAX pipeline's condition for its Pallas chain
    (`models/spectrogram.py:154-158`): an even-n1 plan and pad_factor >= 2."""
    return plan is not None and plan.n1 % 2 == 0 and cfg.pad_factor >= 2


def flip_supported(plan: FftPlan) -> bool:
    """n2 a whole number of 128-lane tiles (`stft_kernel.py:56`)."""
    return plan.n2 % 128 == 0


def padded_n2(plan: FftPlan) -> int:
    """n2 rounded up to a whole 128-lane tile (`stft_kernel.py:66`)."""
    return -(-plan.n2 // 128) * 128


def lane_pad_default(plan: FftPlan) -> bool:
    """The padded-lane layout's default: where the direct flip fails and the
    pad costs no lane tile (`stft_kernel.py:491`)."""
    return not flip_supported(plan) and 2 * (plan.n2 % 128) > 128


def packed_supported(plan: FftPlan, lane_pad: bool = False) -> bool:
    """Where the TPU's stereo-packed kernel applies (`stft_kernel.py:261`)."""
    return plan.n1 % 2 == 0 and (lane_pad or flip_supported(plan))


def split_framing_supported(cfg: SpectrogramConfig, k: int = 1,
                            plan: Optional[FftPlan] = None) -> bool:
    """The TPU's all-windows gate: hop a multiple of n1
    (`stft_kernel.py:769`)."""
    plan = plan or make_plan(cfg)
    return (
        plan is not None
        and plan.n1 % 2 == 0
        and cfg.pad_factor >= 2
        and cfg.hop_size % plan.n1 == 0
    )


def carry_transposed_supported(cfg: SpectrogramConfig,
                               plan: Optional[FftPlan] = None) -> bool:
    """Where the transposed carry applies: hop a multiple of n1, so a hop
    boundary falls between whole columns (`stft_kernel.py:1240`)."""
    plan = plan or make_plan(cfg)
    return (
        plan is not None
        and plan.n1 % 2 == 0
        and cfg.pad_factor >= 2
        and cfg.hop_size % plan.n1 == 0
    )


def buf_framing_supported(cfg: SpectrogramConfig, k: int = 1,
                          plan: Optional[FftPlan] = None) -> bool:
    """The TPU's DMA-offset framing gate: window and hop multiples of n1,
    and for k > 1 hop / n1 a multiple of 8 (`stft_kernel.py:1254`)."""
    plan = plan or make_plan(cfg)
    ok = (
        plan is not None
        and plan.n1 % 2 == 0
        and cfg.pad_factor >= 2
        and cfg.window_size % plan.n1 == 0
        and cfg.hop_size % plan.n1 == 0
    )
    if not ok:
        return False
    return k == 1 or (cfg.hop_size // plan.n1) % 8 == 0


def tsplit_supported(cfg: SpectrogramConfig, k: int = 1,
                     plan: Optional[FftPlan] = None,
                     lane_pad: bool = False) -> bool:
    """Where the carry+chunk framing applies: k=1, hop a multiple of n1 and
    shorter than the window, and a flip-capable plan
    (`stft_kernel.py:1390`)."""
    plan = plan or make_plan(cfg)
    return (
        plan is not None
        and k == 1
        and plan.n1 % 2 == 0
        and cfg.pad_factor >= 2
        and cfg.hop_size % plan.n1 == 0
        and cfg.hop_size < cfg.window_size
        and (lane_pad or flip_supported(plan))
    )
