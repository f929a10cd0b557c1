"""Times this checkout against another on one card, in turns.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/ab_general_route.py OTHER_CHECKOUT [--phases kernels]

``OTHER_CHECKOUT`` is a second copy of the repository (a parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists, such
as ``build/parent``). The script runs ``python3 chip_smoke.py --phases
<phases>`` four times, other / this / this / other, each from its own root
and building its own kernels, and writes each run's output to
``<out>/<n>_<which>.log`` (``--out``, by default ``build/ab``). It then prints, per geometry of the
general route and per kernel, the four runs' median device times, and per
kernel of the kernels line its ``ms`` in the four runs. It fails if any run
fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ORDER = ("other", "this", "this", "other")
GEOMETRY = re.compile(r"^general route (\[[^\]]*\] heads=\d+ ws=\d+ \S+ \S+"
                      r" \w+),")
TIME = re.compile(r"(k[1-4]) err.*?(?<![a-z_])ms=([\d.]+) / ([\d.]+) / "
                  r"([\d.]+)")
BREAKDOWN = re.compile(r"^general K\d .* device us a call by kernel: ")


def run(root: Path, phases: str, log: Path) -> str:
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                               phases], cwd=root, stdout=f,
                              stderr=subprocess.STDOUT)
    text = log.read_text()
    if proc.returncode != 0:
        sys.stdout.write(text[-4000:])
        raise SystemExit(f"{log}: exit {proc.returncode}")
    return text


def medians(text: str) -> dict:
    """{(geometry, kernel): median ms} of the general route's lines."""
    found = {}
    for line in text.splitlines():
        m = GEOMETRY.match(line)
        if m:
            for k, _, med, _ in TIME.findall(line):
                found[(m.group(1), k)] = float(med)
    return found


def kernels_line(text: str) -> dict:
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            return {k["name"]: k.get("ms") for k in json.loads(line)["kernels"]}
    return {}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--phases", default="kernels")
    parser.add_argument("--out", type=Path, default=Path("build") / "ab")
    args = parser.parse_args()
    here = Path.cwd()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    texts = []
    for i, which in enumerate(ORDER, 1):
        root = args.other.resolve() if which == "other" else here
        texts.append(run(root, args.phases, out / f"{i}_{which}.log"))
        print(f"run {i} ({which}) done", flush=True)
    for line in texts[0].splitlines():
        if "NVIDIA" in line and "W" in line and "," in line:
            print(line)
            break
    runs = [medians(t) for t in texts]
    print("general route, median ms: other / this / this / other")
    for key in sorted(set().union(*runs)):
        vals = [r.get(key) for r in runs]
        print(f"  {key[0]} {key[1]}: " + " / ".join(
            "-" if v is None else f"{v:.4f}" for v in vals))
    lines = [kernels_line(t) for t in texts]
    print("kernels line ms: other / this / this / other")
    for name in lines[1]:
        vals = [ln.get(name) for ln in lines]
        print(f"  {name}: " + " / ".join(
            "-" if v is None else f"{v:.4f}" for v in vals))
    for line in texts[1].splitlines():
        if BREAKDOWN.match(line):
            print("this: " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
