"""One rank of tests/test_torch_parallel.py's multi-process runs, on the
CPU through gloo:

    python tests/torch_parallel_worker.py <task> <rank> <world> <init url> <dir>

joins the group at <init url> (file://...), runs <task> on the inputs the
test saved in <dir>/inputs.pt and saves this rank's results in
<dir>/rank<r>.pt. The tasks:

* syncbn: one train-mode BatchNorm2d forward on this rank's rows and the
  backward of sum(out * g): the output, the input gradient, the summed
  parameter gradients, the running statistics.
* step: one train step of the port from the driver's own `build` (the
  run's generator, global draws), optionally in float64.
* replay: one train step on replayed global draws (this rank's rows of the
  square stripes and the PGD start), the attack's own x_adv kept and the
  given x_adv (JAX's) used for the update, as torch_port_helpers does.
* noise: free-AT's replay noise through save_noise / load_noise.

Imports no JAX."""

import os
import sys

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from edge_enhancement_tpu_torch.parallel import mesh  # noqa: E402


def _rows(t):
    return mesh.shard_rows(t)


def syncbn(inp):
    from edge_enhancement_tpu_torch.models.batchnorm import BatchNorm2d
    bn = BatchNorm2d(inp["x"].shape[1]).double()
    bn.load_state_dict(inp["state"])
    x = _rows(inp["x"]).clone().requires_grad_(True)
    out = bn(x)
    (out * _rows(inp["g"])).sum().backward()
    grads = mesh.sum_across([bn.weight.grad, bn.bias.grad])
    return {"out": out.detach(), "dx": x.grad, "dweight": grads[0],
            "dbias": grads[1], "state": bn.state_dict()}


def _step_result(state, metrics):
    return {"state": state.model.state_dict(), "momentum": state.momentum_buf,
            "step": state.step, "metrics": {k: v.item() for k, v in metrics.items()}}


def step(inp):
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.train.trainer import OptimConfig, build_train_step
    cfg = inp["cfg"]
    ops, state, gen = driver.build(cfg, inp["num_classes"], torch.device("cpu"))
    state.model.to(inp["dtype"])
    state.momentum_buf = [b.to(inp["dtype"]) for b in state.momentum_buf]
    mesh.replicate(state.model)
    train_step = build_train_step(ops, driver.make_method_config(cfg, inp["num_classes"]),
                                  OptimConfig(inp["momentum"], inp["weight_decay"]), gen)
    m = train_step(state, _rows(inp["x"]).to(inp["dtype"]), _rows(inp["y"]), inp["lr"])
    return _step_result(state, m)


class _RowReplay:
    """A square source replaying global draws, this rank's stripe rows."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, shape, n_queries=1):
        stripes, mask, sign = self.draws[self.calls]
        self.calls += 1
        return _rows(stripes), mask, sign


def replay(inp):
    from edge_enhancement_tpu_torch.attacks import pgd as tpgd
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.objectives import methods as tmethods
    from edge_enhancement_tpu_torch.train import trainer
    from edge_enhancement_tpu_torch.train.modelops import ModelOps
    model = build_model(inp["arch"], inp["ee_args"], inp["num_classes"])
    model.load_state_dict(inp["state"])
    model.square_source = source = _RowReplay(inp["draws"])
    noise, x_adv_given, kept = _rows(inp["noise"]), _rows(inp["x_adv"]), {}
    tpgd.uniform_init_noise = lambda x, eps, gen: noise
    real = tpgd.pgd_linf

    def spy(*args, **kwargs):
        kept["x_adv"] = real(*args, **kwargs)
        return x_adv_given.clone()
    tmethods.pgd_linf = spy
    state = trainer.create_train_state(model)
    train_step = trainer.build_train_step(
        ModelOps(model), tmethods.MethodConfig(inp["method"], **inp["fields"]),
        trainer.OptimConfig(inp["momentum"], inp["weight_decay"]))
    m = train_step(state, _rows(inp["x"]), _rows(inp["y"]), inp["lr"])
    assert source.calls == len(inp["draws"])
    return {**_step_result(state, m), "x_adv": kept["x_adv"]}


def noise(inp):
    from edge_enhancement_tpu_torch.train import checkpoint, driver
    mine = _rows(inp["noise"])
    path = checkpoint.save_noise(inp["dir"], mine)
    back = checkpoint.load_noise(inp["dir"])
    log = []
    # a resume at another batch size: the shard does not fit
    other = driver._load_noise({"resume": inp["dir"]},
                               torch.zeros((mine.shape[0] + 1,) + mine.shape[1:]),
                               log.append)
    return {"path": os.path.basename(path), "back": back, "other": other,
            "log": log}


TASKS = {"syncbn": syncbn, "step": step, "replay": replay, "noise": noise}


def main():
    task, rank, world, init, out = sys.argv[1:6]
    mesh.init("cpu", init_method=init, rank=int(rank), world_size=int(world))
    try:
        inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
        result = TASKS[task](inp)
        result["world"] = mesh.world_size()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
