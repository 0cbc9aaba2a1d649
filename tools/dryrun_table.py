"""Render the records of ``python -m repro_torch.launch.dryrun --all`` as
the markdown table that PERF.md keeps: one row per (architecture x shape),
the 16x16 and 2x16x16 cells side by side as "a / b".

    PYTHONPATH=src python3 tools/dryrun_table.py results/dryrun_torch.json
"""
import json
import sys

MESHES = ("16x16", "2x16x16")
KINDS = (("all-gather", "AG"), ("all-reduce", "AR"), ("reduce-scatter", "RS"),
         ("all-to-all", "A2A"))


def _g(x, unit=1.0, digits=3):
    return f"{x / unit:.{digits}g}"


def _pair(recs, fn):
    return " / ".join(fn(recs[m]) if m in recs else "—" for m in MESHES)


def render(records):
    cells, other = {}, []
    for r in records:
        if r.get("status") == "ok":
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
        else:
            other.append(r)
    head = ["arch", "shape", "flops/dev", "bytes/dev (GB)"]
    head += [f"{short} GB" for _, short in KINDS]
    head += ["compute ms", "memory ms", "collective ms", "bottleneck",
             "roofline_frac", "arg GB", "temp GB", "wall s"]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import LM_SHAPES
    for (arch, shape), recs in sorted(cells.items(), key=lambda c: (
            ARCHS.index(c[0][0]), LM_SHAPES.index(c[0][1]))):
        row = [arch, shape,
               _pair(recs, lambda r: _g(r["per_device_flops"])),
               _pair(recs, lambda r: _g(r["per_device_bytes"], 1e9))]
        for kind, _ in KINDS:
            row.append(_pair(recs, lambda r, k=kind: _g(
                r["collective_detail"][k], 1e9)))
        row += [_pair(recs, lambda r: _g(r["compute_s"], 1e-3)),
                _pair(recs, lambda r: _g(r["memory_s"], 1e-3)),
                _pair(recs, lambda r: _g(r["collective_s"], 1e-3)),
                _pair(recs, lambda r: r["bottleneck"]),
                _pair(recs, lambda r: _g(r["roofline_frac"], 1, 2)),
                _pair(recs, lambda r: _g(r["arg_bytes_per_device"], 1e9)),
                _pair(recs, lambda r: _g(r["temp_bytes_per_device"], 1e9)),
                _pair(recs, lambda r: f"{r['wall_s']:.0f}")]
        lines.append("| " + " | ".join(row) + " |")
    by_status = {}
    for r in other:
        key = (r["status"], r.get("reason", r.get("error")))
        by_status.setdefault(key, {}).setdefault(
            f"{r['arch']} {r['shape']}", []).append(r["mesh"])
    notes = [f"- **{status}** ({sum(map(len, cells_.values()))} cells): "
             + ", ".join(f"{c} ({' and '.join(m)})" for c, m in cells_.items())
             + f": {reason}" for (status, reason), cells_ in by_status.items()]
    return "\n".join(lines + [""] + notes)


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(render(json.load(f)))
