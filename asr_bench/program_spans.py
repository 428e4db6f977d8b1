"""What the port's own spans tallied in a traced run's profiled window.

While a profiler records, each ``rg.*`` span of ``robust_e2e_gan_torch/
utils/trace.py`` adds its entries and host seconds to ``SPAN_HOST``; a
traced run records only its profiled window, so the tally is that
window's. A program without the tally, or without the span, reads None.
"""

from __future__ import annotations

from typing import Optional, Sequence


def tally() -> Optional[dict]:
    """The port's ``SPAN_HOST``, or None where the program has none."""
    try:
        from robust_e2e_gan_torch.utils import trace
    except ImportError:
        return None
    return getattr(trace, "SPAN_HOST", None)


def per_entry(name: str) -> Optional[float]:
    """Host seconds an entry of span ``name``."""
    spans = tally()
    if not spans or not spans.get(name) or not spans[name][0]:
        return None
    return spans[name][1] / spans[name][0]


def per_unit(run, names: Sequence[str]) -> Optional[float]:
    """Host seconds of the spans ``names`` together, a profiled batch or
    step; None without a profile or where none of them ran."""
    prof = run.get("profile")
    spans = tally()
    if prof is None or not spans or not any(n in spans for n in names):
        return None
    return sum(spans[n][1] for n in names if n in spans) / prof.units
