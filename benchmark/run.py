"""Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks for
(``BENCHMARK.json``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; then ``checks``, each number that
decided ``correct`` beside its limit, which are also the last lines of
standard error. Without a card, or with fewer than the cell asks for, it
exits with 2 and prints no result; it exits with 3 if a module of JAX or
of the JAX package is loaded once the window has closed.

``--calibrate N`` reads the correctness numbers instead, on N seeds from
``--seed`` on, in one process: the program's, the program's with each of
its kind's faults planted, and those of the reference computed in the
lower precisions (and, for training, with half of each batch left out),
each against the exact reference. One JSON line a seed. It times
nothing.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0,
                   help="read the correctness numbers on this many seeds")
    return p.parse_args(argv)


def result_line(spec: dict, ctx, out: dict, device_name: str,
                here=None) -> dict:
    """The result's JSON object, ``checks`` last."""
    from benchmark import harness
    cell = ctx.cell["name"]
    metrics = {}
    if not ctx.trace:
        values = dict(out["e2e"], setup_s=out["setup_s"],
                      peak_gib=(out["peak"] - out["held"]) / 2 ** 30)
        for m in spec["end_to_end"]:
            if cell in m.get("workloads", [cell]):
                name = m["name"]
                # ``<metric>.<family>`` is ``<metric>`` under a bound of its
                # own, for the cells that the family lists
                value = (values[name] if name in values
                         else values[name.split(".", 1)[0]])
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        from benchmark.flops import step_flops
        reading = harness.Reading(
            model=ctx.model, batch=ctx.traffic["batch"], trace=out["trace"],
            steps=out["steps"], window_s=out["window_s"],
            flops_per_step=step_flops(
                ctx.reference, ctx.model, out["spec"], ctx.traffic["batch"],
                ctx.traffic["kind"] == "train"))
        metrics = harness.per_layer(spec, cell, reading,
                                    here or harness.HERE)
    device = {"platform": "gpu", "kind": device_name,
              "count": ctx.cell["chips"], "memory_peak_bytes": out["peak"]}
    line = {"correct": (harness.judge(out["readings"], ctx.limits)
                        and out["failed"] == 0),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.span_s)
        line["breakdown"] = tr.breakdown()
    line["checks"] = harness.checks_line(out["readings"], ctx.limits)
    return line


def context(spec: dict, args, device, t0: float, fault=None, root=None):
    """The run's context, with the configuration's reference loaded and
    its wiring checked; ``root`` is the checkout (this one's by
    default)."""
    from benchmark import harness
    root = harness.ROOT if root is None else root
    here = root / "benchmark"
    cell = harness.find_cell(spec, args.workload)
    traffic = harness.load_json("traffic", cell["traffic"], here)
    limits = harness.load_json("cells", cell["name"], here)["limits"]
    config = harness.find_config(spec, cell["config"], root)
    reference = harness.load_reference(config, here)
    reference.check_config(config["model"])
    return harness.Context(cell=cell, model=config["model"],
                           reference=reference, traffic=traffic,
                           limits=limits, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=device, t0=t0, fault=fault)


def run_cell(spec: dict, args, device, t0: float, fault=None,
             device_name: str = "cpu", root=None):
    """One run of a cell on ``device``: the result's JSON object and the
    set-up's marks. ``fault`` plants one of the kinds' faults under the
    timed path (the checks' tests); ``root`` is the checkout whose files
    name the cell."""
    import importlib
    import torch
    ctx = context(spec, args, device, t0, fault, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    kind = importlib.import_module(f"benchmark.kinds.{ctx.traffic['kind']}")
    out = kind.run(ctx)
    return (result_line(spec, ctx, out, device_name,
                        None if root is None else root / "benchmark"),
            ctx.marks)


def calibrate(spec: dict, args, device, emit=print) -> None:
    import dataclasses
    import importlib
    from benchmark.reference.prec import control_for
    ctx = context(spec, args, device, T0)
    kind = importlib.import_module(f"benchmark.kinds.{ctx.traffic['kind']}")
    precs = [control_for(ctx.model["dtype"])]
    for i in range(args.calibrate):
        seed = args.seed + 7919 * i
        t = time.perf_counter()
        got = kind.calibrate(dataclasses.replace(ctx, seed=seed), precs)
        emit(json.dumps({"seed": seed, "seconds": time.perf_counter() - t,
                         **got}))


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    if args.calibrate:
        calibrate(spec, args, device,
                  emit=lambda s: print(s, flush=True))
        return 0
    line, marks = run_cell(spec, args, device, T0,
                           device_name=torch.cuda.get_device_name(0))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package are loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in marks),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
