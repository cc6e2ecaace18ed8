"""One rank of the port's multi-process CPU tests
(tests/test_torch_sharding.py): joins a gloo job, runs the tasks of a job
file on the meshes they name, and writes its results.

    python tests/torch_sharding_worker.py JOB OUT ADDRESS WORLD RANK

It imports torch and the port, never JAX.  `run_steps` is also the
tests' unsharded reference.
"""

import sys

import torch


def build_model(cfg, kind, state, backbone):
    """RC-Net or the SML holding `state`, in its dtype."""
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    dtype = state["decoder.output0.conv.weight" if kind == "rcnet"
                  else "first_conv.weight"].dtype
    model = (RCNet(cfg.rcnet, "cpu", dtype) if kind == "rcnet"
             else ScaleMapLearner(cfg.sml, "cpu", dtype, **backbone))
    model.load_state_dict(state)
    return model


def run_steps(task, wrap=lambda step: step):
    """task["steps"] (2 by default) training steps of the task's model
    (RC-Net or SML) on its batch, each step wrapped by `wrap`: the first
    step's aux and gradients, and the state_dict after the last step
    (None when `wrap` gives no step)."""
    from riders_tpu_torch.pipelines import rcnet_training, sml_training
    cfg = task["cfg"]
    model = build_model(cfg, task["model"], task["state"],
                        task.get("backbone", {}))
    if task["model"] == "rcnet":
        state = rcnet_training.init_rcnet_train_state(cfg, model, 0.1)
        step = rcnet_training.make_rcnet_train_step(cfg)
    else:
        state = sml_training.init_train_state(cfg, model, 0.1)
        step = sml_training.make_train_step(cfg)
    step = wrap(step)
    if step is None:
        return None
    out = {}
    for i in range(task.get("steps", 2)):
        state, aux = step(state, task["batch"])
        if i == 0:
            out["aux"] = {k: float(v) for k, v in aux.items()}
            out["grads"] = {k: p.grad.detach().clone()
                            for k, p in model.named_parameters()
                            if p.grad is not None}
    out["state"] = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
    return out


def _fused(sh, task):
    from riders_tpu_torch.pipelines.fused import make_sharded_fused_fn
    cfg = task["cfg"]
    rcnet = build_model(cfg, "rcnet", task["rcnet"], {}).eval()
    sml = build_model(cfg, "sml", task["sml"], task["backbone"]).eval()
    mesh = sh.make_mesh(*task["mesh"])
    fn = make_sharded_fused_fn(cfg, rcnet, sml, mesh, device="cpu")
    return {"depth": fn(task["batch"]), "calls": dict(mesh.calls)}


def _step(sh, task):
    mesh = sh.make_mesh(*task["mesh"])
    out = run_steps(task, lambda step: sh.with_data_sharding(mesh, step))
    out["calls"] = dict(mesh.calls)
    return out


def _trainer(sh, task):
    """`drivers._maybe_shard_training` as the trainers call it: at each of
    task["roles"]'s batch sizes this rank's role ("out" when it sits
    out, "whole" for the unwrapped step, else its (first, stop) rows),
    then the task's steps through it on this rank's rows of its batch."""
    from riders_tpu_torch.pipelines import drivers
    cfg, marker = task["cfg"], object()
    roles = {}
    for b in task["roles"]:
        step, rows = drivers._maybe_shard_training(cfg, marker, b)
        roles[b] = ("out" if step is None else "whole" if step is marker
                    else (rows.start, rows.stop))

    def wrap(step):
        sharded, rows = drivers._maybe_shard_training(
            cfg, step, len(task["batch"]["image"]))
        return None if sharded is None else lambda state, batch: sharded(
            state, {k: v[rows] for k, v in batch.items()})

    return {"roles": roles, "steps": run_steps(task, wrap)}


def _shard(sh, task):
    mesh = sh.make_mesh(*task["mesh"])
    out = {"coords": (mesh.index(sh.DATA_AXIS), mesh.index(sh.POINTS_AXIS)),
           "local": sh.shard_batch(mesh, task["batch"]), "error": None}
    try:
        sh.shard_batch(mesh, {"points": task["batch"]["points"][:, :3]})
    except ValueError as e:
        out["error"] = str(e)
    return out


KINDS = {"fused": _fused, "step": _step, "shard": _shard,
         "trainer": _trainer}


def main(job_path, out_path, address, world, rank):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from riders_tpu_torch.parallel import sharding as sh
    sh.initialize_multihost(address, world, rank, device="cpu",
                            timeout_s=120)
    try:
        job = torch.load(job_path, weights_only=False)
        results = {name: KINDS[task["kind"]](sh, task)
                   for name, task in job.items()}
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    job, out, address, world, rank = sys.argv[1:]
    main(job, out, address, int(world), int(rank))
