"""The traffic generator and the operation counts, on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench import harness, layouts, smoke, train, tree, weights


@pytest.fixture(autouse=True, scope="module")
def _program_on_path():
    harness.boot()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_same_seed_same_batches_and_rows_differ():
    cell = smoke.smoke_cell("minicpm-2b-deq.train-8x1k")
    cpu = torch.device("cpu")
    seed = 2 ** 31 + 12345
    a = [train.batch_for(cell.config, cell.traffic, seed, k, cpu)
         for k in (1, 2)]
    b = [train.batch_for(cell.config, cell.traffic, seed, k, cpu)
         for k in (1, 2)]
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["targets"], y["targets"])
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    rows = a[0]["tokens"]
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert torch.equal(a[0]["tokens"][:, 1:], a[0]["targets"][:, :-1])
    other = train.batch_for(cell.config, cell.traffic, seed + 1, 1, cpu)
    assert not torch.equal(other["tokens"], a[0]["tokens"])


def test_same_seed_same_weights():
    cell = smoke.smoke_cell("minicpm-2b.train-8x1k")
    cpu = torch.device("cpu")
    p = weights.make_params(cell.config, 7, cpu)
    leaf = weights.make_leaf(cell.config, 7, "group0.mlp.wo", cpu)
    assert torch.equal(p["group0"]["mlp"]["wo"], leaf)
    assert not torch.equal(
        leaf, weights.make_leaf(cell.config, 8, "group0.mlp.wo", cpu))


def _counted(cell, params, batch):
    from repro_torch.models import lm

    mcfg = layouts.layout(cell.config).model_config(cell.config).with_(
        remat="none", dtype="float32")
    leaves = [t.float().requires_grad_(True) for t in tree.leaves(params)]
    with FlopCounterMode(display=False) as fc:
        loss, aux = lm.loss_fn(tree.rebuild(params, list(leaves)), batch,
                               mcfg)
        torch.autograd.grad(loss, leaves)
    return fc.get_total_flops(), aux


def test_step_flops_match_the_program_counted_on_the_cpu():
    """The formulas against PyTorch's count of the program's loss and
    gradient at a smoke size (on the CPU the attention computes every
    score, so the count takes the full context)."""
    cpu = torch.device("cpu")
    for name in ("minicpm-2b.train-8x1k", "minicpm-2b-deq.train-8x1k"):
        cell = smoke.smoke_cell(name)
        cfg, tr = cell.config, cell.traffic
        params = weights.make_params(cfg, 3, cpu)
        batch = train.batch_for(cfg, tr, 3, 1, cpu)
        got, aux = _counted(cell, params, batch)
        iters = int(aux.get("deq_steps", 0))
        want = layouts.layout(cfg).train_step_flops(
            cfg, tr["batch"], tr["seq"], iters, ctx=tr["seq"])
        # the program's attention backward recomputes the scores (one more
        # attention forward a layer), which the model's count leaves out
        hq = cfg["num_attention_heads"] * cfg["head_dim"]
        want += (tr["batch"] * tr["seq"] * cfg["num_hidden_layers"]
                 * 4 * tr["seq"] * hq)
        # the DEQ's count also holds the solver's small ring products
        assert abs(got - want) / want < (0.05 if iters else 1e-6), \
            (name, got, want)
