"""Serving example: slot-pool continuous batching + DSLOT digit-serial MLPs
+ SLO-driven precision elasticity (port of ``examples/serve_lm.py``).

Serves the seamless-m4t backbone (the assigned arch whose ReLU FFN admits
DSLOT early negative termination) in reduced form through the batch
``generate`` API, then drives the slot-pool ``ServeEngine``: streaming
tokens as they land, and shedding digit planes per QoS tier when an
admission burst overloads the pool.

    python -m repro_torch.launch.serve_lm [--device cpu]

Everything runs on ``--device`` (default ``cuda``: the CUDA kernel; ``cpu``
runs its plain version).  Weights and inputs come from fixed seeds (torch
generators where the example draws JAX keys, so the numbers differ from the
example's; the traffic is the example's numpy draw, so the engine schedules
are the same).  Returns what it printed as a dict.
"""

import argparse
import dataclasses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.base import DslotConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import stats
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import (DEGRADABLE, RESERVED, STANDARD, Request,
                                   ServeConfig, ServeEngine, SloConfig,
                                   generate)

    dev = resolve_device(args.device)
    out = {}
    cfg = get_arch("seamless-m4t-medium").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (4, 12), generator=gen,
                                device=dev),
        "src_embeds": torch.randn((4, 8, cfg.d_model), generator=gen,
                                  device=dev) * 0.02,
    }
    res = generate(model, params, batch, 8)
    out["tokens_shape"] = tuple(res.tokens.shape)
    print("enc-dec batched generation:", out["tokens_shape"])

    # ---- DSLOT digit-serial MLPs (ReLU FFN -> early termination applies)
    dcfg = dataclasses.replace(cfg, dslot=DslotConfig(
        enabled=True, n_planes=8, block_m=16, block_n=16))
    dmodel = build_model(dcfg)
    dparams = dmodel.prepare_dslot(params)      # weight-stationary lowering,
    res2 = generate(dmodel, dparams, batch, 8)  # done once for all requests
    out["agrees"] = float((res.tokens == res2.tokens).float().mean()) > 0.9
    print("dslot-mode generation agrees with dense:", out["agrees"])
    # per-request runtime precision + planes-executed accounting
    res3 = generate(dmodel, dparams, batch, 8, n_planes=torch.tensor(
        [8, 8, 4, 2], dtype=torch.int32, device=dev))
    used = res3.planes_used_mean.tolist()
    skip = res3.skipped_frac.tolist()
    out["requests"] = list(zip(used, skip))
    for i in range(len(used)):
        print(f"  request {i}: planes/row {used[i]:.2f}, "
              f"skipped {skip[i]:.1%}")
    # forward statistics through the stats side channel
    with stats.collect() as sink:
        dmodel.forward(dparams, batch)
    vals = [float(v.float().mean()) for v in
            sink.get("mlp_dslot_skipped_frac", [])]
    out["dslot_calls"] = len(vals)
    if vals:
        print(f"digit-serial MLP calls: {len(vals)}, mean skipped "
              f"digit-plane passes {np.mean(vals):.1%}")

    # ---- slot-pool continuous batching with batched chunked admission:
    # try_add only enqueues; each engine step runs ONE batched admission
    # forward (up to chunks_per_step prompts, one prefill_chunk each, at
    # ragged offsets) beside the pooled decode
    lcfg = get_arch("olmo-1b").reduced()
    lmodel = build_model(lcfg)
    lparams = lmodel.init(torch.Generator(dev).manual_seed(2), device=dev)
    eng = ServeEngine(lmodel, lparams, ServeConfig(
        n_slots=2, max_len=48, prefill_chunk=4, chunks_per_step=2))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, lcfg.vocab_size,
                                        size=3 + 4 * i).astype(np.int32),
                    max_new=3 + i) for i in range(4)]
    # streaming, push form: uid 0 reports every token the step it lands
    reqs[0].on_token = lambda req, tok, step: print(
        f"    uid {req.uid} token {tok} @ step {step}")
    for r in reqs:
        eng.try_add(r)                   # non-blocking: queued, FIFO
    finished, out["steps"] = [], []
    while len(finished) < len(reqs):
        finished += eng.step()
        out["steps"].append((eng.slot_phases(), eng.queue_depth))
        print(f"  step {eng.steps:2d}: slots={eng.slot_phases()} "
              f"queued={eng.queue_depth}")
    out["served"] = {r.uid: (len(r.out), r.result.ttft_steps)
                     for r in finished}
    print("continuous batching: served", len(finished), "requests;",
          {r.uid: (len(r.out), f"ttft={r.result.ttft_steps} steps")
           for r in finished})
    # streaming, pull form: a generator handle drives the engine itself
    tail = Request(uid=99, prompt=rng.integers(
        0, lcfg.vocab_size, size=6).astype(np.int32), max_new=4)
    out["streamed"] = list(eng.stream(tail))
    print("  streamed:", out["streamed"], "ttft =", tail.result.ttft_steps,
          "steps")

    # ---- SLO-aware precision elasticity: QoS tiers under an overload
    # burst.  A calibrated DSLOT model (fixed act_scale: chunk-invariant
    # quantization) serves a 4x burst; the SloController sheds degradable
    # tiers' digit planes to hold latency, never touches reserved's floor,
    # and restores them once the queue drains.
    scfg = dataclasses.replace(
        lcfg, act="relu", glu=False,
        dslot=DslotConfig(enabled=True, block_m=16, block_n=32, block_k=16,
                          act_scale=0.05))
    smodel = build_model(scfg)
    sparams = smodel.init(torch.Generator(dev).manual_seed(3), device=dev)
    eng2 = ServeEngine(smodel, sparams, ServeConfig(
        n_slots=2, max_len=48, prefill_chunk=4, chunks_per_step=2,
        slo=SloConfig(queue_high_water=2, shed_patience=2,
                      restore_patience=2, target_ttft_steps=8)))
    tiers = [RESERVED, STANDARD] + [DEGRADABLE] * 6
    burst = [Request(uid=i, tier=t,
                     prompt=rng.integers(0, scfg.vocab_size,
                                         size=8).astype(np.int32),
                     max_new=4)
             for i, t in enumerate(tiers)]
    for r in burst:
        eng2.try_add(r)
    while not all(r.done for r in burst):
        eng2.step()
    out["tiers"] = {}
    for tier in (RESERVED, STANDARD, DEGRADABLE):
        rs = [r.result for r in burst if r.tier == tier]
        planes = float(np.mean([r.planes_used_mean for r in rs]))
        p95 = float(np.percentile([r.ttft_steps for r in rs], 95))
        out["tiers"][tier] = (planes, p95, len(rs))
        print(f"  {tier:10s} planes/row {planes:.2f}  ttft p95 {p95:.0f}"
              f" steps  [{len(rs)} reqs]")
    out["controller"] = eng2.slo.summary()
    print("  controller:", out["controller"])
    return out


if __name__ == "__main__":
    main()
