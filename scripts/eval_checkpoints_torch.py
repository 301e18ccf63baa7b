#!/usr/bin/env python3
"""Evaluate every final checkpoint of the PyTorch port with play_torch.py.

The port's counterpart of ``scripts/eval_checkpoints.py``: for each
``checkpoints/DirGate_*/poca_final`` (or the directories given), run
``scripts/play_torch.py`` twice, stochastic and deterministic, each in its
own process, and print one markdown table of the returns' mean, std, min,
max and median (reference play.py:215-223). ``--device`` is passed on to
play_torch.py; the default is the card.

Usage:
    python scripts/eval_checkpoints_torch.py [--episodes 10] [--device cpu] [ckpt_dir ...]
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_eval(ckpt: pathlib.Path, episodes: int, deterministic: bool, seed: int,
             device: str | None) -> dict | None:
    cmd = [sys.executable, str(ROOT / "scripts" / "play_torch.py"),
           "--checkpoint", str(ckpt), "--num_episodes", str(episodes),
           "--seed", str(seed)]
    if device is not None:
        cmd += ["--device", device]
    if deterministic:
        cmd.append("--deterministic")
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    except subprocess.TimeoutExpired:
        # one hung eval must not discard the rows already collected
        print(f"[eval] {ckpt} timed out after 3600s, skipping", file=sys.stderr)
        return None
    if out.returncode != 0:
        print(f"[eval] {ckpt} FAILED:\n{out.stderr[-2000:]}", file=sys.stderr)
        return None
    stats = {}
    for key in ("mean", "std", "min", "max", "median"):
        m = re.search(rf"^\s*{key}\s*:\s*(-?[\d.]+)", out.stdout, re.M)
        if m:
            stats[key] = float(m.group(1))
    return stats or None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*",
                    help="checkpoint run dirs (default: checkpoints/DirGate_*)")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="passed on to play_torch.py: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> list:
    """Evaluate; returns the table's rows (run, mode, stats)."""
    args = build_parser().parse_args(argv)

    dirs = ([pathlib.Path(d) for d in args.dirs] or
            sorted((ROOT / "checkpoints").glob("DirGate_*")))
    rows = []
    for d in dirs:
        final = d / "poca_final" if (d / "poca_final").is_dir() else d
        if not (final / "metadata.json").exists():
            print(f"[eval] {d}: no final checkpoint, skipping", file=sys.stderr)
            continue
        for det in (False, True):
            s = run_eval(final, args.episodes, det, args.seed, args.device)
            if s:
                rows.append((d.name, "det" if det else "stoch", s))
                print(f"[eval] {d.name} ({'det' if det else 'stoch'}): "
                      f"mean {s['mean']:.2f} ± {s['std']:.2f}", flush=True)

    print("\n| run | mode | mean | std | min | max | median |")
    print("|---|---|---|---|---|---|---|")
    for name, mode, s in rows:
        print(f"| {name} | {mode} | {s['mean']:.2f} | {s['std']:.2f} | "
              f"{s['min']:.2f} | {s['max']:.2f} | {s['median']:.2f} |")
    return rows


if __name__ == "__main__":
    main()
