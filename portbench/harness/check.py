"""What decides ``correct``: the served tokens against the plain reference.

After the window, a sample of the finished requests (drawn from the seed,
the longest among them) is run through the float32 reference, each prompt
with its served tokens.  At every served position the reference's best
logit less the logit of the token the program served is that token's gap;
the widest gap over the sample is compared with the configuration's limit.
Greedy decoding serves the argmax, so a sound program's gaps come only from
its rounding; a wrong token shows as a gap of the logits' own size.

The control (not run by the benchmark's runs) reads the same gap for the
token that the reference computed in float8 puts first at each position.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def pick(candidates: list, k: int, seed: int, size) -> list:
    """``k`` of ``candidates`` drawn from the seed, the largest by
    ``size`` always among them."""
    if len(candidates) <= k:
        return list(candidates)
    rng = np.random.default_rng([int(seed), 0xC4EC])
    big = max(range(len(candidates)), key=lambda i: size(candidates[i]))
    rest = [i for i in range(len(candidates)) if i != big]
    chosen = [big] + list(rng.choice(rest, size=k - 1, replace=False))
    return [candidates[i] for i in sorted(chosen)]


def _logits(params, model, dslot, step, sample, device, precision):
    """Reference logits at the positions whose next token was served."""
    served = sample["served"]
    prompt = torch.as_tensor(sample["prompt"], dtype=torch.long)
    toks = torch.cat([prompt, torch.as_tensor(served[:-1], dtype=torch.long)])
    seq = {"tokens": toks.to(device)}
    for key in ("frontend", "src"):
        if key in sample:
            seq[key] = sample[key].to(device)
    P = len(prompt)
    rows = torch.arange(P - 1, P - 1 + len(served), device=device)
    return ref.forward(params, model, seq, dslot=dslot, step=step,
                       planes=int(sample["planes"]), precision=precision,
                       rows=rows)


def gaps(params, model: dict, dslot: dict, step: float, samples: list,
         device, control: bool = False) -> dict:
    """The widest served-token gap over ``samples`` (and with ``control``
    the widest gap of the float8 reference's first tokens), with the
    number of tokens compared."""
    worst, worst_ctl, n = 0.0, 0.0, 0
    for s in samples:
        lg = _logits(params, model, dslot, step, s, device, "f32")
        served = torch.as_tensor(s["served"], dtype=torch.long,
                                 device=device)
        best = lg.max(dim=-1).values
        got = lg.gather(1, served[:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
        n += len(s["served"])
        if control:
            lo = _logits(params, model, dslot, step, s, device, "fp8")
            first = lo.argmax(dim=-1)
            ctl = best - lg.gather(1, first[:, None])[:, 0]
            worst_ctl = max(worst_ctl, float(ctl.max()))
        del lg
    out = {"logit_gap": worst, "tokens": n}
    if control:
        out["control_gap"] = worst_ctl
    return out
