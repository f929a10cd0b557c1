"""The frozen plain reference against the program's plain path at TINY on
the CPU: the forward in inference and in training mode (the same noise from
a generator of the same seed), and three training steps (losses, Nadam's
first gradient, the parameters' change). This test imports both; nothing
that a chip run loads imports the program into the reference."""

import pytest
import torch

from benchmark import compare, pool as pools, weights
from benchmark.kinds import infer, train
from benchmark.reference import model as ref_model
from benchmark.tests.conftest import (INFER, TRAIN, port_config,
                                      tiny_context, tiny_model)


@pytest.mark.parametrize("fg_msa", [True, False])
@pytest.mark.parametrize("training", [False, True])
def test_forward_equals_the_programs_plain_path(fg_msa, training):
    from strajnet_tpu_torch.models.strajnet import STrajNet
    model = tiny_model(dtype="float32", fg_msa=fg_msa, fg=fg_msa)
    net = STrajNet(port_config(model)).train(training)
    spec = weights.spec_of(net.state_dict())
    p = weights.draw(spec, 17, "cpu", ref_model.LEAF_RULES)
    net.load_state_dict(p)
    b = pools.make_pool(pools.with_sizes(model), 3, 1, 9, "cpu", True)[0]
    g1 = torch.Generator().manual_seed(5) if training else None
    g2 = torch.Generator().manual_seed(5) if training else None
    with torch.no_grad():
        y = net(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
                occ=b["occl_actors"], mapt=b["centerlines"],
                flow=b["vec_flow"], generator=g1)
        r = ref_model.forward(p, model, b, generator=g2)
    assert float((y - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("name", ["strajnet_fgmsa_bf16",
                                  "strajnet_trainpy_f32"])
def test_training_steps_equal_the_programs(name):
    model = tiny_model(name, dtype="float32")
    ctx = tiny_context(model, TRAIN)
    prog = train.Program(ctx)
    got = prog.check_steps(3)
    ref = train.reference_steps(ctx, prog.spec, prog.pool, 3)
    gaps = compare.training_gaps(got, ref)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["out_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-5
    assert gaps["update_gap"] < 1e-4


def test_served_outputs_equal_the_programs():
    model = tiny_model(dtype="float32")
    ctx = tiny_context(model, INFER)
    prog = infer.Program(ctx)
    got = prog.call(1)
    ref = infer.reference(ctx, prog.spec, prog.pool[1], 2)
    gaps = infer.gaps(got, ref)
    assert gaps["out_gap"] < 1e-5


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path
    here = Path(ref_model.__file__).parent
    for path in here.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    assert m.split(".")[0] not in (
                        "strajnet_tpu_torch", "strajnet_tpu", "jax"), path
