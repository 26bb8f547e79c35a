"""Schedule auto-planner CLI: the twin of the JAX package's
``launch/plan.py``, with the same flags and defaults and, for the same
flags, the same output. ``--chip h100`` and ``--link nvlink4`` add the H100
figures of ``core/h100.py``.

    PYTHONPATH=src python -m repro_torch.launch.plan --config llama_65b --hbm-gb 80
    PYTHONPATH=src python -m repro_torch.launch.plan --config gpt3_96b \
        --attention recompute --top 12
    PYTHONPATH=src python -m repro_torch.launch.plan --config qwen3-14b \
        --trace step.trace.json --trace-b 2

Prints the ranked plan table (every candidate, including OOM-pruned and
break-even-rejected rows with the required_stage_gain bar they failed)
and a one-line recommendation per attention arm. Costs come from the
paper's Table 5 measurements for its two models, an analytic roofline
guess otherwise, or a real executor trace via --trace.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, list_configs
from repro_torch.core.h100 import H100_NVLINK_BW, H100_PEAK_BF16
from repro_torch.core.notation import (A100_PEAK_BF16, NVLINK_BW,
                                 TPU_V5E_ICI_BW, TPU_V5E_PEAK_BF16,
                                 from_model)
from repro_torch.planner import (SearchSpace, calibrate, cost_model_for,
                           plan_config, report)

LINKS = {"nvlink": NVLINK_BW, "ici": TPU_V5E_ICI_BW,
         "nvlink4": H100_NVLINK_BW}
CHIPS = {"a100": A100_PEAK_BF16, "tpu_v5e": TPU_V5E_PEAK_BF16,
         "h100": H100_PEAK_BF16}


def resolve_config(name: str):
    """Accept registry names and their underscore aliases
    (gpt3_96b -> gpt3-96b), per the docs' CLI examples."""
    for cand in (name, name.replace("_", "-"), name.replace("_", ".")):
        try:
            return get_config(cand)
        except KeyError:
            continue
    raise SystemExit(f"unknown --config {name!r}; known: {list_configs()}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="rank pipeline-schedule plans for a config")
    ap.add_argument("--config", required=True,
                    help="model config name (underscores ok: llama_65b)")
    ap.add_argument("--hbm-gb", type=float, default=80.0,
                    help="per-device HBM budget (default: A100-80G)")
    ap.add_argument("--p", type=int, default=8, help="pipeline stages")
    ap.add_argument("--t", type=int, default=4, help="tensor-parallel size")
    ap.add_argument("--B", type=int, default=128, help="global batch")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--attention", default="",
                    choices=["", "none", "recompute", "flash"],
                    help="restrict to one attention arm")
    ap.add_argument("--residency", default="", nargs="*",
                    help="residency policies to search on plain kinds "
                         "(default: none host_offload selective_recompute; "
                         "balanced kinds always carry bpipe_swap)")
    ap.add_argument("--link", default="nvlink", choices=sorted(LINKS),
                    help="evictor<->acceptor link for BPipe traffic")
    ap.add_argument("--host-bw", type=float, default=0.0,
                    help="host D2H/H2D bandwidth in GB/s for host_offload "
                         "(default: PCIe gen4 x16)")
    ap.add_argument("--chip", default="a100", choices=sorted(CHIPS))
    ap.add_argument("--v", type=int, nargs="*", default=[2, 4],
                    help="interleaved chunks-per-device to search")
    ap.add_argument("--depth", type=int, nargs="*", default=[1, 2],
                    help="transfer-overlap depths to search for "
                         "residency-managed plans (in-flight moves per "
                         "channel; depth 1 = serialized classic)")
    ap.add_argument("--seq-chunks", type=int, nargs="*", default=[1],
                    help="sequence slices per microbatch to search, e.g. "
                         "--seq-chunks 1 2 4 (docs/longcontext.md; c > 1 "
                         "only on kinds with a sliced builder and seq "
                         "lengths c divides; default: unsliced only)")
    ap.add_argument("--vocab-parallel", type=int, nargs="*", default=[1],
                    help="vocab-parallel degrees to search, e.g. "
                         "--vocab-parallel 1 2 4 (docs/memory.md 'Vocab "
                         "accounting'; vp > 1 scatters the embedding/head/"
                         "logits spike over vp boundary stages for "
                         "per-microbatch collective traffic; degrees > p "
                         "are skipped; default: unscattered only)")
    ap.add_argument("--overhead", type=float, default=0.0,
                    help="fractional BPipe overhead inflating break-even")
    ap.add_argument("--exhaustive", action="store_true",
                    help="simulate every feasible candidate instead of the "
                         "branch-and-bound search (same recommendation, "
                         "slower — docs/planner.md 'Search performance')")
    ap.add_argument("--verbose", action="store_true",
                    help="print search statistics: verdict counts and the "
                         "compile-cache hit/miss/bind counters")
    ap.add_argument("--top", type=int, default=16,
                    help="table rows to print (0 = all)")
    ap.add_argument("--csv", action="store_true",
                    help="machine-readable rows instead of the table")
    ap.add_argument("--spec-json", action="store_true",
                    help="also print each arm's recommended plan as a "
                         "ScheduleSpec JSON line (hand it to the "
                         "executor/simulator via ScheduleSpec.from_dict)")
    ap.add_argument("--perfetto", default="",
                    help="write the recommended plan's simulated timeline "
                         "as a Perfetto/Chrome trace JSON (stage tracks, "
                         "channel tracks, HBM counter tracks — open in "
                         "ui.perfetto.dev)")
    ap.add_argument("--metrics-json", default="",
                    help="write the recommended plan's step metrics "
                         "(bubble%%, stalls, channel occupancy, per-stage "
                         "HBM peaks) as JSON")
    ap.add_argument("--trace", default="",
                    help="Chrome-trace JSON from executor step(trace=True); "
                         "calibrates Tf/Tb instead of Table5/analytic costs")
    ap.add_argument("--trace-b", type=int, default=1,
                    help="micro batch size the trace ran at")
    ap.add_argument("--trace-v", type=int, default=1,
                    help="chunks per device in the traced run")
    ap.add_argument("--trace-c", type=int, default=1,
                    help="sequence slices per microbatch in the traced run")
    ap.add_argument("--trace-attention", default="none",
                    choices=["none", "recompute", "flash"],
                    help="attention arm the traced run used (other arms "
                         "are scaled by the analytic time factors)")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.config)
    n = from_model(cfg, b=1, s=args.seq, B=args.B, p=args.p, t=args.t)
    attentions = ((args.attention,) if args.attention
                  else ("none", "recompute", "flash"))
    kw = {}
    if args.residency:
        from repro_torch.memory import policy as respol
        valid = sorted(n for n, p in respol.POLICIES.items() if not p.swap)
        for name in args.residency:
            if name not in valid:
                # bpipe_swap is registered but not a plain-kind residency
                # (it is the balanced kinds' built-in mechanism)
                raise SystemExit(f"unknown --residency {name!r}; known: "
                                 f"{valid}")
        kw["residencies"] = tuple(args.residency)
    search = SearchSpace(attentions=attentions, vs=tuple(args.v),
                         depths=tuple(args.depth),
                         seq_chunkses=tuple(args.seq_chunks),
                         vocab_parallels=tuple(args.vocab_parallel), **kw)

    if args.trace:
        events = calibrate.load_chrome_trace(args.trace)
        costs = calibrate.fit_trace(events, v=args.trace_v, b=args.trace_b,
                                    seq_chunks=args.trace_c)
        cost = calibrate.TraceCostModel(costs, peak_per_chip=CHIPS[args.chip],
                                        attention=args.trace_attention)
        print(f"# calibrated from {args.trace}: Tf={costs.Tf:.4g}s "
              f"Tb={costs.Tb:.4g}s ({costs.samples} events)")
    else:
        cost = cost_model_for(cfg, CHIPS[args.chip])

    if args.verbose:
        from repro_torch.core import plan as plan_mod
        plan_mod.compile_cache_stats(reset=True)
    ranked = plan_config(n, cfg, args.hbm_gb * 2**30, cost=cost,
                         search=search, link_bw=LINKS[args.link],
                         overhead=args.overhead,
                         host_bw=(args.host_bw * 1e9 if args.host_bw
                                  else None),
                         exhaustive=args.exhaustive)
    if args.verbose:
        from collections import Counter

        from repro_torch.core import plan as plan_mod
        counts = Counter(p.verdict for p in ranked)
        simulated = sum(1 for p in ranked if p.makespan > 0)
        stats = plan_mod.compile_cache_stats()
        print(f"# search: {len(ranked)} enumerated, {simulated} simulated, "
              + ", ".join(f"{counts.get(k, 0)} {k}"
                          for k in ("ok", "reject", "pruned", "infeasible")))
        print(f"# compile cache: {stats['hits']} hits, "
              f"{stats['misses']} misses, {stats['binds']} depth-binds, "
              f"{stats['evictions']} evictions, size {stats['size']}"
              f"/{stats['maxsize']}")
    if args.csv:
        for row in report.csv_rows(ranked, "plan", cfg.name):
            print(row)
    else:
        print(f"# {cfg.name}: p={n.p} t={n.t} B={n.B} s={n.s} "
              f"hbm={args.hbm_gb:.0f}GiB link={args.link} "
              f"({len(ranked)} candidates)")
        print(report.format_table(ranked, top=args.top))
    for line in report.summarize(cfg.name, n, ranked):
        print(line)
    if args.perfetto or args.metrics_json:
        import json

        from repro_torch.core import memory_model as mm
        from repro_torch.core import plan as plan_mod
        from repro_torch.core import simulator as SIM
        from repro_torch.obs import Recorder
        from repro_torch.obs import export as obs_export
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.planner.rank import recommend, sim_config_for
        best = recommend(ranked, args.attention or None)
        if best is None:
            print("# nothing to export: no feasible plan", file=sys.stderr)
        else:
            # Re-simulate the winning plan with a recorder attached —
            # the exact SimConfig rank priced it with — so the exported
            # timeline/metrics describe the plan the CLI recommended.
            rec = Recorder()
            simcfg = sim_config_for(n, best, cost, LINKS[args.link],
                                    args.host_bw * 1e9 if args.host_bw
                                    else None)
            res = SIM.simulate(simcfg, observer=rec)
            spec = simcfg.spec
            nb = n.replace(b=best.cand.b)
            counters = obs_metrics.hbm_timeline(
                rec.spans, plan_mod.compile_plan(spec).partner,
                mm.sliced_unit_bytes(nb, best.cand.attention, spec.v,
                                     spec.seq_chunks),
                retained_bytes=spec.policy.retained_bytes(
                    nb, best.cand.attention, spec.v),
                p=spec.p)
            if args.perfetto:
                obs_export.save_trace(rec.spans, args.perfetto,
                                      counters=counters)
                print(f"# wrote Perfetto trace: {args.perfetto} "
                      f"({len(rec.spans)} spans)")
            if args.metrics_json:
                met = obs_metrics.compute(
                    rec.spans, p=spec.p,
                    model_flops=cost.full_flops(n), t=n.t,
                    peak_flops=cost.peak_per_chip,
                    channel_stats=res.channels)
                with open(args.metrics_json, "w") as f:
                    json.dump({"config": cfg.name,
                               "spec": spec.to_dict(),
                               "metrics": met.to_dict(),
                               "hbm_peaks": obs_metrics.hbm_peaks(counters)},
                              f, indent=1)
                print(f"# wrote metrics JSON: {args.metrics_json}")
    if args.spec_json:
        import json
        from repro_torch.planner.rank import arms_of, recommend
        for arm in arms_of(ranked) + [None]:
            best = recommend(ranked, arm)
            if best is None:
                continue
            print(json.dumps({
                "arm": arm or "overall", "b": best.cand.b,
                "attention": best.cand.attention,
                "spec": best.cand.spec(n.p).to_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
