"""One rank of tests/test_torch_parallel.py's multi-process runs, on the
CPU through gloo:

    python tests/torch_parallel_worker.py <task> <rank> <world> <init url> <dir> [n_model]

joins the group at <init url> (file://...) on a (data, model) mesh with a
`model` axis of n_model (default 1), runs <task> on the inputs the test
saved in <dir>/inputs.pt and saves this rank's results in
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
* tp_step: one train step of the driver's build with the model cut over
  the `model` axis (parallel/sharding.py), in float64: the first attack
  gradient, the state, a validation batch's metrics; then the checkpoint
  (gathered over the model group), a restore from a one-process file and
  the noise files.
* tp_replay: one Net2 train step with the model cut over the `model`
  axis on replayed global draws (the dropout masks and the PGD start, this
  rank's data rows), the attack's own x_adv kept and the given x_adv used
  for the update.
* tp_sum: mesh.sum_step on a cut Net2's parameters, once with gradients
  that differ on every rank and once with gradients alike on the model
  ranks of a data row, beside the data group's own sum of the latter.
* chain: the flagship's chained step (build_chained_train_step, the
  loop form under gloo) from the driver's own `build`, and the same K
  batches as K single steps from a fresh build, optionally in float64;
  the model cut over the `model` axis where the mesh has one, the state
  gathered into the one-process layout.
* chain_replay: the chained step on replayed global draws (this rank's
  rows of each step's square stripes and PGD start), each step's own
  x_adv kept and the given one (JAX's) used for its update; cut and
  gathered as in chain.
* awp: AWP steps (objectives/awp.py) of the driver's build of an AWP
  config in float64, with the model cut over the `model` axis, each
  variant (awp_on, l1) from a fresh build; the state gathered into the
  one-process layout. With `noise` and `x_adv` (one a variant) given: the
  PGD start and the update's x_adv replayed (this rank's data rows), each
  step's own x_adv kept.

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


def _first_input_grad(grads):
    """Wrap the attacks' input gradient so that each call's result is kept."""
    from edge_enhancement_tpu_torch.attacks import pgd
    real = pgd._input_grad

    def kept(loss_fn, x):
        grads.append(real(loss_fn, x))
        return grads[-1]
    pgd._input_grad = kept


def tp_step(inp):
    from edge_enhancement_tpu_torch.parallel import sharding
    from edge_enhancement_tpu_torch.train import checkpoint, driver
    from edge_enhancement_tpu_torch.train.trainer import (OptimConfig, build_eval_step,
                                                          build_train_step)
    cfg, n = inp["cfg"], inp["num_classes"]
    ops, state, gen = driver.build(cfg, n, torch.device("cpu"))
    state.model.double()
    state.momentum_buf = [b.double() for b in state.momentum_buf]
    mesh.replicate(state.model)
    sharding.shard_state(state)
    opt = OptimConfig(inp["momentum"], inp["weight_decay"])
    grads = []
    _first_input_grad(grads)
    train_step = build_train_step(ops, driver.make_method_config(cfg, n), opt, gen)
    m = train_step(state, _rows(inp["x"]).double(), _rows(inp["y"]), inp["lr"])
    eval_step = build_eval_step(ops, driver.eval_attack(cfg, n), gen)
    ev = eval_step(state, _rows(inp["vx"]).double(), _rows(inp["vy"]))
    result = {**_step_result(state, m), "grad0": grads[0],
              # copies: the restore below writes into the live tensors
              "state": {k: v.clone() for k, v in state.model.state_dict().items()},
              "momentum": [b.clone() for b in state.momentum_buf],
              "eval": {k: v.item() for k, v in ev.items()},
              "shapes": {k: tuple(v.shape) for k, v in state.model.state_dict().items()}}
    checkpoint.save_checkpoint(inp["dir"], state, 1, cfg["arch"], 0.0, False, opt, inp["lr"])
    state, epoch, _ = checkpoint.restore_into_state(
        state, checkpoint.load_checkpoint(inp["resume"]))
    result["restored"] = {"epoch": epoch, "state": state.model.state_dict(),
                          "momentum": state.momentum_buf}
    result["noise_path"] = os.path.basename(checkpoint.save_noise(
        inp["dir"], _rows(inp["x"])))
    mesh.barrier()
    return result


def tp_replay(inp):
    from edge_enhancement_tpu_torch.attacks import pgd as tpgd
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.objectives import methods as tmethods
    from edge_enhancement_tpu_torch.parallel import sharding
    from edge_enhancement_tpu_torch.train import trainer
    from edge_enhancement_tpu_torch.train.modelops import ModelOps
    model = build_model(inp["arch"], {}, inp["num_classes"])
    model.load_state_dict(inp["state"])
    masks = list(inp["masks"])
    model.dropout_source = lambda shape: _rows(masks.pop(0))
    noise, x_adv_given, kept = _rows(inp["noise"]), _rows(inp["x_adv"]), {}
    tpgd.uniform_init_noise = lambda x, eps, gen: noise
    real = tpgd.pgd_linf

    def spy(*args, **kwargs):
        kept["x_adv"] = real(*args, **kwargs)
        return x_adv_given.clone()
    tmethods.pgd_linf = spy
    state = sharding.shard_state(trainer.create_train_state(model))
    train_step = trainer.build_train_step(
        ModelOps(model), tmethods.MethodConfig(inp["method"], **inp["fields"]),
        trainer.OptimConfig(inp["momentum"], inp["weight_decay"]))
    m = train_step(state, _rows(inp["x"]), _rows(inp["y"]), inp["lr"])
    assert not masks
    return {**_step_result(state, m), "x_adv": kept["x_adv"]}


def tp_sum(inp):
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.parallel import sharding
    model = sharding.shard_model(build_model("Net2", {}, 10).double())
    params = list(model.parameters())
    r = mesh.rank()
    apart, _ = mesh.sum_step([torch.full_like(p, r + 1.0) for p in params],
                             {"loss": torch.tensor(float(r))}, model)
    gen = torch.Generator().manual_seed(mesh.data_rank())
    alike = [torch.randn(p.shape, generator=gen, dtype=p.dtype) for p in params]
    summed, metrics = mesh.sum_step(alike, {"loss": torch.tensor(float(r))}, model)
    return {"names": [n for n, _ in model.named_parameters()], "apart": apart,
            "alike": summed, "data_sum": mesh.sum_across(alike),
            "loss": metrics["loss"].item()}


def _stack_rows(ts):
    return torch.stack([_rows(t) for t in ts])


def _gathered_result(state, metrics):
    """_step_result with the state gathered over the model group."""
    from edge_enhancement_tpu_torch.parallel import sharding
    sd, mom = sharding.gather_state(state)
    return {**_step_result(state, metrics), "state": sd, "momentum": mom}


def chain(inp):
    from edge_enhancement_tpu_torch.parallel import sharding
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.train.trainer import (OptimConfig,
                                                          build_chained_train_step,
                                                          build_train_step)
    cfg, n, dtype = inp["cfg"], inp["num_classes"], inp["dtype"]
    xs, ys = _stack_rows(inp["xs"]).to(dtype), _stack_rows(inp["ys"])
    out = {}
    for form in ("single", "chained"):
        ops, state, gen = driver.build(cfg, n, torch.device("cpu"))
        state.model.to(dtype)
        state.momentum_buf = [b.to(dtype) for b in state.momentum_buf]
        mesh.replicate(state.model)
        sharding.shard_state(state)
        parts = (ops, driver.make_method_config(cfg, n),
                 OptimConfig(inp["momentum"], inp["weight_decay"]), gen)
        if form == "single":
            step = build_train_step(*parts)
            for x, y in zip(xs, ys):
                m = step(state, x, y, inp["lr"])
        else:
            step = build_chained_train_step(*parts)
            m = step(state, xs, ys, inp["lr"])
            assert step.capture_seconds is None           # the loop form
        out[form] = _gathered_result(state, m)
    return out


def chain_replay(inp):
    from edge_enhancement_tpu_torch.attacks import pgd as tpgd
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.objectives import methods as tmethods
    from edge_enhancement_tpu_torch.parallel import sharding
    from edge_enhancement_tpu_torch.train import trainer
    from edge_enhancement_tpu_torch.train.modelops import ModelOps
    model = build_model(inp["arch"], inp["ee_args"], inp["num_classes"])
    model.load_state_dict(inp["state"])
    model.double()
    model.square_source = source = _RowReplay(inp["draws"])
    noise, given, kept = iter(inp["noise"]), iter(inp["x_adv"]), []
    tpgd.uniform_init_noise = lambda x, eps, gen: _rows(next(noise)).to(x.dtype)
    real = tpgd.pgd_linf

    def spy(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return _rows(next(given)).to(args[1].dtype)
    tmethods.pgd_linf = spy
    state = sharding.shard_state(trainer.create_train_state(model))
    step = trainer.build_chained_train_step(
        ModelOps(model), tmethods.MethodConfig(inp["method"], **inp["fields"]),
        trainer.OptimConfig(inp["momentum"], inp["weight_decay"]))
    m = step(state, _stack_rows(inp["xs"]).double(), _stack_rows(inp["ys"]), inp["lr"])
    assert source.calls == len(inp["draws"]) and len(kept) == len(inp["xs"])
    return {**_gathered_result(state, m), "x_adv": kept}


def awp(inp):
    from edge_enhancement_tpu_torch.attacks import pgd as tpgd
    from edge_enhancement_tpu_torch.objectives import awp as tawp
    from edge_enhancement_tpu_torch.parallel import sharding
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.train.trainer import OptimConfig
    cfg, n, given = inp["cfg"], inp["num_classes"], inp.get("x_adv")
    kept, current = [], {}
    if given is not None:
        tpgd.uniform_init_noise = lambda x, eps, gen: _rows(inp["noise"]).to(x.dtype)
        real = tawp.pgd_linf

        def spy(*args, **kwargs):
            kept.append(real(*args, **kwargs))
            return _rows(current["x_adv"]).to(args[1].dtype)
        tawp.pgd_linf = spy
    out = []
    for i, (awp_on, l1) in enumerate(inp["variants"]):
        if given is not None:
            current["x_adv"] = given[i]
        ops, state, gen = driver.build(cfg, n, torch.device("cpu"))
        if inp.get("weights") is not None:
            state.model.load_state_dict(inp["weights"])
        state.model.double()
        state.momentum_buf = [b.double() for b in state.momentum_buf]
        mesh.replicate(state.model)
        sharding.shard_state(state)
        step = tawp.build_awp_train_step(
            ops, driver.make_method_config(cfg, n),
            OptimConfig(inp["momentum"], inp["weight_decay"]),
            tawp.AWPConfig(gamma=inp["gamma"], proxy_lr=inp["proxy_lr"], l1=l1), gen)
        m = step(state, _rows(inp["x"]).double(), _rows(inp["y"]), inp["lr"], awp_on)
        sd, mom = sharding.gather_state(state)
        out.append({"state": sd, "momentum": mom, "step": state.step,
                    "metrics": {k: v.item() for k, v in m.items()}})
    return {"variants": out, "x_adv": kept}


TASKS = {"syncbn": syncbn, "step": step, "replay": replay, "noise": noise,
         "tp_step": tp_step, "tp_replay": tp_replay, "tp_sum": tp_sum, "chain": chain,
         "chain_replay": chain_replay, "awp": awp}


def main():
    task, rank, world, init, out = sys.argv[1:6]
    n_model = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    mesh.init("cpu", init_method=init, rank=int(rank), world_size=int(world),
              n_model=n_model)
    try:
        inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
        result = TASKS[task](inp)
        result["world"] = mesh.world_size()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
