"""The comparison that decides `correct`.

After the window the program is freed and the plain reference
(`reference/model.py`, fp32, TF32 off) scores the same videos under the
same prompt, from the same seeded weights drawn again group by group. Each
number is a relative gap over the compared videos, ||program - reference||
/ ||reference||, of one quantity the timed path produced: `features_gap`
(mlp1's output for every frame), `motion_gap` (the motion embedding),
`readout_gap` (the score head's input) and `score_head_gap` (the scores,
against the reference's score head run on the program's own readout).

The scores are judged by the head stage alone because the whole chain does
not separate bf16 from the control: a score is a sum of ReLU outputs under
non-negative last weights, where the chain's errors partly cancel, and over
36 seeds a cell the control's smallest `score_gap` (the scores against the
reference's own) was only 1.3-1.5x the program's largest. The stage before
the head is held by `readout_gap`; `score_gap` is still computed.

A cell's limits (`limits/<cell>.json`) say which numbers it holds and how
far each may go. The control puts the reference computed in fp8
(`Numerics(fp8=True)`) in the program's place (`harness.run_cell(control=
True)`, which `calibrate.py` runs): its own features, motion embedding and
readout, and its fp8 score head on the program's readout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.reference import model as ref


def reference_outputs(cfg: dict, weights, data: dict, device, fp8: bool = False) -> Dict:
    """The reference's outputs on the compared videos, and under 'head' its
    score head on the program's readout."""
    ref.use_fp32()
    ids = torch.as_tensor(data["ids"], device=device)
    pixels = torch.as_tensor(data["pixels"], device=device)
    num = ref.Numerics(fp8)
    with torch.no_grad():
        out = ref.score_videos(cfg, weights.group, num, ids, pixels)
        readout = data["program"]["readout"].to(device).float()
        out["head"] = ref.score_head(cfg, weights.group, num, readout)
    weights.release()
    return out


def relative_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    r = r.double()
    p = p.to(r.device).double()
    return float((p - r).norm() / r.norm().clamp_min(1e-300))


def gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> Dict[str, float]:
    numbers = {f"{key}_gap": relative_gap(p, reference[key]) for key, p in program.items()}
    numbers["score_head_gap"] = relative_gap(program["score"], reference["head"])
    return numbers


def control_gaps(program: Dict[str, torch.Tensor], ref8: Dict[str, torch.Tensor],
                 ref32: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers the control reads: the fp8 reference's outputs in place
    of the program's, and its fp8 head on the program's readout."""
    numbers = {f"{key}_gap": relative_gap(ref8[key], ref32[key]) for key in program}
    numbers["score_head_gap"] = relative_gap(ref8["head"], ref32["head"])
    return numbers


def within(value: Optional[float], limit: float) -> bool:
    return value is not None and math.isfinite(value) and value <= limit
