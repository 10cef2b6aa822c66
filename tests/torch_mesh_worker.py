"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``): joins a
gloo process group through a file store, runs one task on the CPU, writes
its results with ``torch.save`` and leaves the group.  It imports the port
and never JAX.  The test file starts the ranks with :func:`spawn`.

    python tests/torch_mesh_worker.py TASK RANK WORLD STORE DATA MC IN_PATH OUT_DIR
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

TINY = dict(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
            max_pulses=8, d_model=32, n_layers=2, n_heads=4, dropout=0.1,
            dtype=torch.float32)
BACKENDS = ("xla", "xla_remat", "pallas")


def spawn(task: str, world: int, data: int, mc: int, tmp: Path, inputs: dict,
          timeout: float = 150.0) -> list:
    """Run ``task`` on ``world`` ranks of a ``data × mc`` mesh; returns each
    rank's results.  A rank that fails or outlasts ``timeout`` seconds fails
    the call (the others are killed)."""
    tmp.mkdir(parents=True, exist_ok=True)
    in_path = tmp / f"{task}_in.pt"
    torch.save(inputs, in_path)
    store = tmp / f"{task}_store"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(store), str(data), str(mc),
         str(in_path), str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read() for p in procs]
    for p in procs:
        p.stdout.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{task}: ranks {bad} failed or timed out after {timeout} s:\n"
                             + "\n".join(f"--- rank {r}\n{log[-3000:]}"
                                         for r, log in enumerate(logs)))
    return [torch.load(tmp / f"{task}_rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# tasks: each gets the mesh and the parent's inputs, returns a dict
# ---------------------------------------------------------------------------

def _full_grad(mesh, local_grad, global_shape, rows, cols=None, scale=1.0):
    """The global gradient from each rank's block gradient: zero-padded,
    summed over the ranks, times ``scale``."""
    full = torch.zeros(global_shape, dtype=local_grad.dtype)
    index = (rows,) if cols is None else (rows, cols)
    full[index] = local_grad
    return mesh.all_reduce_(full) * scale


def task_objectives(mesh, inp):
    """make_mean_fidelity, make_objective and make_per_target_objective on
    the rank's blocks: values and the global pulse gradient."""
    from universal_quantum_optimal_control_tpu_torch.parallel import (
        DATA_AXIS, MC_AXIS, make_mean_fidelity, shard_spec)
    from universal_quantum_optimal_control_tpu_torch.training import (
        SU2System, make_objective, make_per_target_objective)

    pulses, q_t, delta, eps, w = (inp[k] for k in ("pulses", "q_t", "delta", "eps", "w"))
    rows = shard_spec(mesh, DATA_AXIS)
    block = shard_spec(mesh, DATA_AXIS, MC_AXIS)
    r = mesh.block(pulses.shape[0], DATA_AXIS)
    c = mesh.block(delta.shape[1], MC_AXIS)
    out = {}
    for backend in BACKENDS:
        fns = {"mean_fidelity": make_mean_fidelity(mesh, backend)}
        local = SU2System(backend).local_mean_fidelity
        obj = make_objective(mesh, local)
        fns["objective"] = lambda p, q, d, e, obj=obj: obj(p, q, (d, e))
        for name, fn in fns.items():
            p = rows(pulses).requires_grad_(True)
            v = fn(p, rows(q_t), block(delta), block(eps))
            v.backward()
            out[(name, backend)] = (v.detach(), _full_grad(
                mesh, p.grad, pulses.shape, r, scale=fn.grad_scale if name == "mean_fidelity"
                else obj.grad_scale))
        per = make_per_target_objective(mesh, local)
        p = rows(pulses).requires_grad_(True)
        f = mesh.gather(per(p, rows(q_t), (block(delta), block(eps))), DATA_AXIS)
        torch.sum(w * f).backward()
        out[("per_target", backend)] = (f.detach(), _full_grad(
            mesh, p.grad, pulses.shape, r, scale=per.grad_scale))
    # the disorder gradient of the batch mean, through B1's plain version
    p = rows(pulses)
    d = block(delta).requires_grad_(True)
    fn = make_mean_fidelity(mesh, "pallas")
    fn(p, rows(q_t), d, block(eps)).backward()
    out["delta_grad"] = _full_grad(mesh, d.grad, delta.shape, r, c, scale=fn.grad_scale)
    return out


def _tiny_trainer(mesh, inp, **cfg):
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    from universal_quantum_optimal_control_tpu_torch.training import TrainConfig, Trainer

    model = UniversalQOCTransformer(**TINY, device="cpu")
    model.load_state_dict(inp["params"])
    config = TrainConfig(monte_carlo=inp["delta"].shape[1], batch_size=inp["rv"].shape[0],
                         learning_rate=1e-3, backend="pallas", **cfg)
    return Trainer(model, config, mesh=mesh, device="cpu")


def _graphs(tr):
    """The trainer's CUDA graph counters and its Adam's capturable flag."""
    return (tr.graphs.captures, tr.graphs.replays,
            [g["capturable"] for g in tr.optimizer.param_groups])


def task_trainer(mesh, inp):
    """Train steps of the tiny transformer on explicit global batches: the
    plain loss and the CVaR loss without dropout, then steps with dropout
    and the trainer's own draws (each: the losses, the steps' gradients,
    the CUDA graph counters, the parameters)."""
    from universal_quantum_optimal_control_tpu_torch.training import CurriculumBand

    out = {}
    for case, cfg in (("plain", {}), ("cvar", {"tail_focus": 0.25, "tail_weight": 0.5})):
        tr = _tiny_trainer(mesh, inp, **cfg)
        tr._place_params()
        losses, grads = [], []
        for _ in range(2):
            loss, fid = tr.train_step(inp["rv"], inp["qt"], (inp["delta"], inp["eps"]))
            # the step's gradient, clipped: Adam leaves .grad as it is
            grads.append(torch.cat([q.grad.flatten() for q in tr.model.parameters()]))
            losses.append((float(loss), float(fid)))
        out[case] = {"losses": losses, "grads": grads, "graphs": _graphs(tr),
                     "params": {k: v.clone() for k, v in tr.model.state_dict().items()}}
    tr = _tiny_trainer(mesh, inp)
    tr._place_params()
    band = CurriculumBand(0.7)
    losses, grads = [], []
    for _ in range(3):
        loss, fid = tr.train_step(inp["rv"], inp["qt"], tr.sample_errors(inp["rv"].shape[0], band),
                                  dropout=True)
        # the step's gradient, summed and clipped: Adam leaves .grad as it is
        grads.append(torch.cat([q.grad.flatten() for q in tr.model.parameters()]))
        losses.append((float(loss), float(fid)))
    out["dropout"] = {"losses": losses, "grads": grads, "graphs": _graphs(tr),
                      "params": {k: v.clone() for k, v in tr.model.state_dict().items()}}
    return out


def task_cli(mesh, inp):
    """The training CLI with ``--mesh`` inside the process group: its
    history, the final parameters, and how often this rank wrote."""
    from universal_quantum_optimal_control_tpu_torch.training import trainer as trainer_mod
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit

    writes = []
    save = trainer_mod.save_checkpoint

    def counted(*a, **k):
        writes.append(k.get("tag"))
        return save(*a, **k)

    trainer_mod.save_checkpoint = counted
    tr, history = universal_single_qubit.run(
        universal_single_qubit.build_parser().parse_args(inp["argv"]))
    return {"history": history, "writes": writes,
            "params": {k: v.clone() for k, v in tr.model.state_dict().items()}}


def task_objectives_card(mesh, inp):
    """``make_mean_fidelity(mesh, "pallas")`` on the card (``cuda:0``, every
    rank): the value, the global pulse gradient and B1's, B3's and B2's
    launches on this rank."""
    from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk
    from universal_quantum_optimal_control_tpu_torch.parallel import (
        DATA_AXIS, MC_AXIS, make_mean_fidelity, shard_spec)

    dev = torch.device("cuda", 0)
    pulses, q_t, delta, eps = (inp[k].to(dev) for k in ("pulses", "q_t", "delta", "eps"))
    rows, block = shard_spec(mesh, DATA_AXIS), shard_spec(mesh, DATA_AXIS, MC_AXIS)
    counters = (tk.mean_fidelity_cuda, tk.propagate_mc_cuda, tk.propagate_mc_vjp_cuda)
    for c in counters:
        c.launches = 0
    fn = make_mean_fidelity(mesh, "pallas")
    p = rows(pulses).requires_grad_(True)
    v = fn(p, rows(q_t), block(delta), block(eps))
    v.backward()
    grad = _full_grad(mesh, p.grad.cpu(), pulses.shape, mesh.block(pulses.shape[0], DATA_AXIS),
                      scale=fn.grad_scale)
    return {"value": v.detach().cpu(), "grad": grad,
            "launches": [c.launches for c in counters]}


TASKS = {"objectives": task_objectives, "trainer": task_trainer, "cli": task_cli,
         "objectives_card": task_objectives_card}


def main(argv) -> None:
    task, rank, world, store, data, mc, in_path, out_dir = argv
    torch.set_num_threads(1)
    from universal_quantum_optimal_control_tpu_torch.parallel import make_mesh
    import torch.distributed as dist

    # gloo for every task: the card tasks put all ranks on cuda:0, which NCCL refuses
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=int(world),
                            rank=int(rank))
    try:
        mesh = make_mesh(data=int(data), mc=int(mc))
        out = TASKS[task](mesh, torch.load(in_path, weights_only=False))
        torch.save(out, Path(out_dir) / f"{task}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
