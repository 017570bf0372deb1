"""What decides ``correct``: the program's outputs from the timed path
against the plain reference under ``portbench/reference/``, after the
window, with the program's state freed.

The traffic kind (``portbench/kinds/<kind>.py``) says what is compared,
in its ``check_numbers(ctx, control)``; this module gives it the
reference of the configuration, the numerics of the reference and of the
control, and the gaps of served tokens. ``numbers(..., control=True)``
puts the control (the reference in fp8, ``reference/lowp.py``) beside the
program, for ``portbench/control.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch


def reference(cfg: dict):
    """The plain reference named by the configuration's ``reference``."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def numerics(control: bool):
    if control:
        from portbench.reference.lowp import Fp8

        return Fp8()
    from portbench.reference.common import Numerics

    return Numerics()


def numbers(ctx, kind, control: bool = False):
    """(the numbers the cell compares, or None where an answer never came;
    the control's numbers where ``control``, else None), by the traffic
    kind's module ``kind``. Gradients are off; a kind that trains turns
    them on itself."""
    from portbench.reference.common import highest_precision

    with torch.no_grad(), highest_precision():
        return kind.check_numbers(ctx, control)


def gaps(ref, ctx, hidden_ref, hidden_ctl, tokens: Optional[torch.Tensor]) -> torch.Tensor:
    """Each position's gap over the rows of one prompt: of ``tokens`` (S,),
    the program's greedy tokens, or of the control's greedy tokens where
    ``hidden_ctl`` is given."""
    from portbench.reference.common import gap_rows

    out = []
    ctl = None
    if hidden_ctl is not None:
        ctl = dict(ref.logits_at(ctx.params, ctx.cfg, hidden_ctl, numerics(True)))
    for s0, lg in ref.logits_at(ctx.params, ctx.cfg, hidden_ref, numerics(False)):
        if ctl is not None:
            tok = ctl[s0].argmax(-1)
        else:
            tok = tokens[s0:s0 + lg.shape[0]].to(lg.device)
        out.append(gap_rows(lg, tok).cpu())
    return torch.cat(out)


def summary(gaps_: list) -> Dict[str, float]:
    """The mean gap over the compared positions (``gap_mean``), the widest
    (``logit_gap``) and the share of positions past 0.25 (``gap_share``)."""
    g = torch.cat(gaps_)
    return {"gap_mean": float(g.mean()), "logit_gap": float(g.max()),
            "gap_share": float((g > 0.25).float().mean())}
