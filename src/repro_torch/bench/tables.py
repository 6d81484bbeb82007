"""Markdown tables of the dry-run records: the status matrix, the roofline
per mesh, baseline → current, and multi-pod.

The counterpart of the JAX package's ``benchmarks/make_tables.py``, over
``launch/dryrun.py``'s records (``bench/roofline.py``'s ``load``), with
three changes: the combinations are counted from the records; a missing
mesh directory gives no rows; the "fits" column is against the 80 GB of
the card named in ``dryrun.DEVICE``.  The port's records have no
collective term (``n/a``) and no compiled peak: their bytes a device are
the arguments' and outputs', a lower bound, printed ``≥``.

    PYTHONPATH=src python -m repro_torch.bench.tables [all|status|roofline|baseline|multipod]
"""
from __future__ import annotations

import argparse

from repro_torch.bench import roofline

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SECTIONS = ("all", "status", "roofline", "baseline", "multipod")


def load(mesh: str) -> dict:
    """The faithful-relay records of ``mesh`` by (arch, shape)."""
    return {(r["arch"], r["shape"]): r for r in roofline.load(mesh)
            if r.get("relay_mode", "faithful") == "faithful"}


def fmt_sec(x) -> str:
    return "n/a" if x is None else f"{x:.2e}"


def _gb(rec: dict) -> str:
    nbytes, exact = roofline.device_bytes(rec)
    return f"{'' if exact else '≥'}{nbytes / 1e9:.2f}"


def _fits(rec: dict) -> str:
    nbytes, exact = roofline.device_bytes(rec)
    if nbytes > roofline.HBM_PER_CHIP:
        return f"no ({nbytes / roofline.HBM_PER_CHIP:.1f}×)"
    return "yes" if exact else "args + outputs fit"


def roofline_table(mesh: str, title: str) -> list[str]:
    recs = load(mesh)
    gb = roofline.HBM_PER_CHIP / 1e9
    lines = [f"\n#### {title}\n",
             "| arch | shape | compute s | memory s | collective s | bottleneck | "
             f"MODEL_FLOPS/counted | peak GB/dev | fits {gb:.0f} GB |",
             "|---|---|---|---|---|---|---|---|---|"]
    for a in sorted({a for a, _ in recs}):
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {a} | {s} | — | — | — | — | — | — | skip (documented) |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {a} | {s} | — | — | — | — | — | — | "
                             f"error: {r['error'][:60]} |")
                continue
            t = r["roofline_seconds"]
            ratio = r.get("useful_flops_ratio")
            lines.append(
                f"| {a} | {s} | {fmt_sec(t['compute'])} | {fmt_sec(t['memory'])} | "
                f"{fmt_sec(t['collective'])} | {r['bottleneck']} | "
                f"{'—' if ratio is None else f'{ratio:.3f}'} | {_gb(r)} | {_fits(r)} |")
    return lines


def dryrun_summary() -> list[str]:
    lines = ["\n#### Status matrix (dry run on meta tensors)\n",
             "| arch | " + " | ".join(f"{s} 1pod / 2pod" for s in SHAPE_ORDER) + " |",
             "|---|" + "---|" * len(SHAPE_ORDER)]
    one, two = load("pod16x16"), load("pod2x16x16")

    def st(r):
        if r is None:
            return "—"
        return {"ok": "✓", "skipped": "skip", "error": "✗"}[r["status"]]

    for a in sorted({a for a, _ in one} | {a for a, _ in two}):
        cells = [f"{st(one.get((a, s)))} / {st(two.get((a, s)))}" for s in SHAPE_ORDER]
        lines.append(f"| {a} | " + " | ".join(cells) + " |")
    recs = list(one.values()) + list(two.values())
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    lines.append(f"\n{len(recs)} combinations: **{n_ok} ok, {n_skip} documented skips, "
                 f"{len(recs) - n_ok - n_skip} errors**.")
    return lines


def baseline_vs_opt() -> list[str]:
    base = load("pod16x16_baseline_v0")
    cur = load("pod16x16")
    lines = [f"\n#### Baseline → current ({len(base)} baseline records, single pod)\n",
             "| arch | shape | coll s (v0→opt) | memory s (v0→opt) | peak GB (v0→opt) |",
             "|---|---|---|---|---|"]
    for (a, s), r0 in sorted(base.items()):
        r1 = cur.get((a, s))
        if r0["status"] != "ok" or r1 is None or r1["status"] != "ok":
            continue
        t0, t1 = r0["roofline_seconds"], r1["roofline_seconds"]
        lines.append(f"| {a} | {s} | {fmt_sec(t0['collective'])} → {fmt_sec(t1['collective'])} | "
                     f"{t0['memory']:.1f} → {t1['memory']:.1f} | {_gb(r0)} → {_gb(r1)} |")
    return lines


def tables(which: str = "all") -> list[str]:
    lines = []
    if which in ("all", "status"):
        lines += dryrun_summary()
    if which in ("all", "roofline"):
        lines += roofline_table("pod16x16", "Single pod 16×16 (roofline of record)")
    if which in ("all", "baseline"):
        lines += roofline_table("pod16x16_baseline_v0",
                                "Single pod 16×16 — paper-faithful baseline (v0)")
        lines += baseline_vs_opt()
    if which in ("all", "multipod"):
        lines += roofline_table("pod2x16x16", "Multi-pod 2×16×16")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=SECTIONS)
    for line in tables(ap.parse_args(argv).which):
        print(line)


if __name__ == "__main__":
    main()
