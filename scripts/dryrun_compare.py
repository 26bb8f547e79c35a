"""Compare the port's production dry-run records with the JAX twin's.

    PYTHONPATH=src python -m repro.launch.dryrun --all --no-roofline --out TWIN
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-roofline --out PORT
    python scripts/dryrun_compare.py TWIN PORT [--markdown]

For every combo that both directories hold, one rank's argument bytes (the
port's less ``unread_argument_bytes``, the arguments its step never reads,
which the twin's ``jax.jit`` prunes) against the twin's, and the temp bytes
(the port's ``MemTracker`` peak less the arguments, the twin's XLA
``temp_size_in_bytes``) with their ratio. ``--markdown`` prints instead a
table of the temps, port / twin GiB, an arch a row and a shape and mesh a
column. Exits non-zero where an argument count differs or a record is
missing on one side.
"""
import argparse
import glob
import json
import os
import sys


def _load(path):
    with open(path) as f:
        return json.load(f)


def rows(twin_dir, port_dir):
    """(name, port record or None, twin record or None) for every combo in
    either directory, in name order."""
    names = sorted({os.path.basename(p) for d in (twin_dir, port_dir)
                    for p in glob.glob(os.path.join(d, "*.json"))})
    for name in names:
        got = [os.path.join(d, name) for d in (port_dir, twin_dir)]
        yield (name[:-5], *[_load(p) if os.path.exists(p) else None
                            for p in got])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("twin")
    ap.add_argument("port")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    bad, temps = 0, {}
    for name, port, twin in rows(args.twin, args.port):
        if port is None or twin is None:
            bad += 1
            print(f"{name}: {'port' if port is None else 'twin'} record missing")
            continue
        pm, tm = port["full"]["memory"], twin["full"]["memory"]
        unread = pm.get("unread_argument_bytes", 0)
        same = pm["argument_bytes"] - unread == tm["argument_bytes"]
        bad += not same
        ratio = pm["temp_bytes"] / max(tm["temp_bytes"], 1)
        arch, rest = name.split("__", 1)
        temps.setdefault(arch, {})[rest] = (pm["temp_bytes"], tm["temp_bytes"])
        if not args.markdown:
            print(f"{name}: args {pm['argument_bytes']:,} less unread {unread:,} "
                  f"{'==' if same else '!='} twin {tm['argument_bytes']:,}; temp "
                  f"{pm['temp_bytes']:,} / {tm['temp_bytes']:,} = {ratio:.2f}")
    if args.markdown:
        cols = sorted({c for t in temps.values() for c in t})
        print("| arch | " + " | ".join(c.replace("__", " ") for c in cols) + " |")
        print("| --- |" + " --- |" * len(cols))
        for arch, t in temps.items():
            print(f"| {arch} | " + " | ".join(
                f"{t[c][0] / 2**30:.2f} / {t[c][1] / 2**30:.2f}" if c in t else "-"
                for c in cols) + " |")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
