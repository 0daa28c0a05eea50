"""K3's check at the 7B full ring over many draw seeds, on the card.

For each seed, phase 9's kernel checks (``chip_smoke.check_fp8_kernels``)
run with a generator of that seed, and each K3 call on the B = 1 full
fp8 ring is also read three ways: the fp8 kernel against its plain
version (the check's reading), the bf16 kernel on the same rings widened
to bf16 (exact) against the same plain version, and the two kernels
against each other; with the number of output elements (and heads) whose
error exceeds 1e-4 of the output's largest value.  Each reading is also
taken by K3's flip rule (``chip_smoke.flip_score``: every head but one
within the limit, that one within one flipped probability more; at most
1 holds), for both kernels and for the control (the plain version with p
in f32), which must break it.  A failed check is logged, not fatal; the
last line says whether the rule held on every seed and the control broke
it on every seed.  Run: ``python3 k3_seed_scan.py --first 20 --count 20
--out k3_scan.json`` (needs one card; about 90 s).
"""
import argparse
import json

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--first", type=int, default=20,
                    help="first seed offset (added to chip_smoke.SEED)")
    ap.add_argument("--count", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_seed_scan.py needs a card")
    from moshi_tpu_torch.models.lm import LMConfig
    from moshi_tpu_torch.nn import decode_attention as da
    cs.fail = lambda msg: cs.log(f"  (logged) {msg}")
    cs.CARD = cs.smi_line()
    cs.REPS = 3
    cfg, scfg = LMConfig(delays=cs._7B_DELAYS), cs.stt_config()
    kernel, plain = da.decode_attention_stacked, da.decode_attention_plain
    tol = cs.TOL["decode_attention"]
    out = []
    for seed in range(args.first, args.first + args.count):
        rec, seen, wide = [], {}, {}

        def read(q, k, v, ck, cv, off, layer, *, cap, context):
            got = kernel(q, k, v, ck, cv, off, layer, cap=cap,
                         context=context)
            if k.dtype != torch.float8_e4m3fn or k.shape[1] != 1 or \
                    seen.get(id(k), 0) >= 2 * cs.DRAWS:
                return got          # the B = 8 rings, or a timed call
            seen[id(k)] = seen.get(id(k), 0) + 1
            if id(k) not in wide:
                wide.clear()
                wide[id(k)] = (k.to(torch.bfloat16), v.to(torch.bfloat16))
            kb, vb = wide[id(k)]
            gb = kernel(q, kb, vb, ck, cv, off, layer, cap=cap,
                        context=context)
            ref = plain(q, k[layer], v[layer], ck, cv, off, cap=cap,
                        context=context, chunk=da.chunk_for(cap))
            with cs.swapped(da, "_bf16_round", lambda t: t):
                ctl = plain(q, k[layer], v[layer], ck, cv, off, cap=cap,
                            context=context, chunk=da.chunk_for(cap))
            bound = cs.flip_bound(q, k[layer], v[layer], off, cap=cap,
                                  context=context, cur_k=ck)
            over = (got - ref).abs() > 1e-4 * float(ref.abs().max())
            rec.append({"fp8": cs.rel_err(got, ref),
                        "bf16": cs.rel_err(gb, ref),
                        "fp8_vs_bf16": cs.rel_err(got, gb),
                        "control": cs.rel_err(ctl, ref),
                        "rule": cs.flip_score(got, ref, bound, tol),
                        "bf16_rule": cs.flip_score(gb, ref, bound, tol),
                        "control_rule": cs.flip_score(ctl, ref, bound, tol),
                        "elems_over_1e-4": int(over.sum()),
                        "heads_over_1e-4": int(over.any(-1).sum())})
            return got

        gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + seed)
        with cs.swapped(da, "decode_attention_stacked", read):
            cs.check_fp8_kernels(cfg, scfg, gen, cs.POOL_B)
        worst = {k: max(r[k] for r in rec) for k in rec[0]}
        # the control must break the rule on every call
        worst["control_rule"] = min(r["control_rule"] for r in rec)
        worst["control"] = min(r["control"] for r in rec)
        cs.log(f"seed SEED + {seed}: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in worst.items()) + f"  [{cs.CARD}]")
        out.append({"seed": seed, "worst": worst, "calls": rec})
    holds = all(s["worst"]["rule"] <= 1 and s["worst"]["bf16_rule"] <= 1
                for s in out)
    broken = all(s["worst"]["control_rule"] > 1 for s in out)
    cs.log(f"flip rule: holds on every seed {holds}; the control breaks it on "
           f"every seed {broken}; largest reading "
           f"{max(s['worst']['rule'] for s in out):.3f}, the control's "
           f"smallest {min(s['worst']['control_rule'] for s in out):.3f}  "
           f"[{cs.CARD}]")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": cs.CARD, "seeds": out, "rule_holds": holds,
                       "control_breaks": broken}, fh, indent=1)


if __name__ == "__main__":
    main()
