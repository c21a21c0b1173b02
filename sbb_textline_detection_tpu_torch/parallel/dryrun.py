"""Multi-process dry run of the port's meshes (the port's counterpart of
the JAX package's `__graft_entry__.dryrun_multichip`).

    python -m sbb_textline_detection_tpu_torch.parallel.dryrun --devices 2
    python -m sbb_textline_detection_tpu_torch.parallel.dryrun \\
        --devices 4 --backend gloo

`spawn` starts N processes, each in a process group of world size N that
meets through a FileStore in a temporary directory (no network port), and
collects what each returns. The dry run asserts that every process sees a
world of N, so that a smaller mesh can never pass as a green run, and
prints the mesh it got. Each process runs one sharded AdamW step of a tiny
TpuUnet on an (N / 2, 2) mesh (N / 1 for N = 1) and checks that the loss
is finite and the gathered weights are whole. Then the parent serves two
small pages through process_batch with a serving mesh of N members and
mesh_auto_group, and checks the group size, that no page degrades, and
that the pages equal the unmeshed detector's.

nccl (the default) puts process r on `cuda:r` (one card each) and the
serving mesh on cuda:0 .. cuda:N-1; gloo runs everything on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

DRYRUN_SPEC = ("dryrun", "tpu_unet", 32, 32, 3)
DRYRUN_WIDTHS = (8, 16)


def _entry(rank, fn, world, backend, tmp, args):
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        if dist.get_world_size() != world:
            raise RuntimeError(f"world size {dist.get_world_size()} != "
                               f"{world}")
        out = fn(*args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str = "gloo", args=()) -> list:
    """fn(*args) in each of `nprocs` new processes of one process group
    (FileStore rendezvous in a temporary directory); returns what each
    rank returned, by rank. `fn` must be importable (module level), and
    what it returns picklable."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(fn, nprocs, backend, tmp, tuple(args)),
                 nprocs=nprocs, join=True)
        outs = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs


def sharded_step(spec_meta: dict, model_parallel: int, state: dict,
                 images: np.ndarray, labels: np.ndarray,
                 optimizer: str = "adamw", lr: float = 3e-4) -> dict:
    """One sharded step of a float32 TpuUnet in this process's group, on a
    (world / model_parallel, model_parallel) mesh: the model starts from
    the whole `state` (numpy arrays by state-dict key), the step takes this
    rank's data slice of the global batch. Returns the mesh shape, the
    data-averaged loss, the names of the sharded parameters and the
    gathered weights after the step (numpy)."""
    import torch.distributed as dist

    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod
    from sbb_textline_detection_tpu_torch.training import train

    spec = registry.ModelSpec.from_meta(spec_meta)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = mesh_mod.make_process_mesh(model_parallel, device.type)
    model = registry.build_module(spec, torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(device).train()
    mesh_mod.shard_module(model, mesh)
    opt = (train.make_optimizer(model.parameters(), lr)
           if optimizer == "adamw"
           else torch.optim.SGD(model.parameters(), lr))
    step = train.make_train_step(spec, model, opt, mesh=mesh)
    rows = mesh_mod.data_slice(mesh, len(images))
    loss = step(torch.from_numpy(images[rows]).to(device),
                torch.from_numpy(labels[rows]).to(device))
    full = mesh_mod.gather_state_dict(model, mesh)
    return {"mesh": tuple(mesh.shape), "loss": float(loss),
            "sharded": sorted(model.tp_sharded),
            "state": {k: v.detach().cpu().numpy() for k, v in full.items()}}


def _dryrun_worker(world: int) -> dict:
    """One rank of the dry run's training half."""
    import torch.distributed as dist

    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.training import train

    assert dist.get_world_size() == world, "smaller world than asked"
    spec = registry.ModelSpec(*DRYRUN_SPEC, widths=DRYRUN_WIDTHS)
    mp_size = 2 if world % 2 == 0 else 1
    state = {k: v.numpy()
             for k, v in registry.init_variables(spec, 0).items()}
    images, labels = train.synthetic_batch(np.random.default_rng(0),
                                           2 * (world // mp_size), 32, 32, 3)
    out = sharded_step(spec.to_meta(), mp_size, state, images, labels,
                       lr=1e-3)
    assert out["mesh"] == (world // mp_size, mp_size), out["mesh"]
    assert np.isfinite(out["loss"]), "dry-run loss is not finite"
    whole = registry.state_shapes(spec)
    assert {k: v.shape for k, v in out["state"].items()} == whole
    assert out["sharded"] or mp_size == 1, "no parameter was sharded"
    return {"mesh": out["mesh"], "loss": out["loss"],
            "sharded": len(out["sharded"])}


def _serve(world: int, backend: str) -> dict:
    """The serving half: two small pages through process_batch on a mesh
    of `world` members, against the unmeshed detector."""
    from sbb_textline_detection_tpu_torch.core.config import (
        DEFAULT_CONFIG, DeskewConfig, ResizePolicy, RuntimeConfig)
    from sbb_textline_detection_tpu_torch.models import registry, runner
    from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    devices = (["cpu"] * world if backend == "gloo"
               else [f"cuda:{i}" for i in range(world)])
    mesh = mesh_mod.make_mesh(devices)
    spec = registry.ModelSpec(*DRYRUN_SPEC, widths=DRYRUN_WIDTHS)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, resize=ResizePolicy(300, 96, 1.0),
        deskew=DeskewConfig(coarse_steps=6, vertical_steps=4),
        runtime=RuntimeConfig(tile_chunk=4, grid_bucket=1, grid_bucket_x=1,
                              deskew_canvas=128, deskew_batch=2))
    specs = {"page": spec, "region": spec, "textline": spec}
    device = devices[0]

    def detector(use_mesh):
        return TextlineDetector(runner.ModelBundle.random_init(
            cfg.runtime, seed=4, device=device, dtype=torch.float32,
            specs=specs, mesh=use_mesh), cfg)

    rng = np.random.default_rng(0)
    pages = [np.where(rng.uniform(size=(120, 100, 3)) < 0.35, 40, 230
                      ).astype(np.uint8) for _ in range(2)]
    det = detector(mesh)
    group = det._effective_group_size()
    assert group == world, f"group size {group} != data axis {world}"
    got = list(det.process_batch(
        (p, f"page_{i}.png") for i, p in enumerate(pages)))
    assert det.degraded == 0 and not any(r.degraded for r in got)
    single = detector(None)
    want = [single.process_image(p, f"page_{i}.png")
            for i, p in enumerate(pages)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.page_coord == w.page_coord, f"page {i}: page box differs"
        assert len(g.contours) == len(w.contours), \
            f"page {i}: {len(g.contours)} regions, unmeshed {len(w.contours)}"
    return {"members": [str(d) for d in mesh.data_members],
            "group": group, "regions": [len(r.contours) for r in got]}


def dryrun(devices: int, backend: str = "gloo") -> dict:
    train_out = spawn(_dryrun_worker, devices, backend, (devices,))
    meshes = {o["mesh"] for o in train_out}
    losses = {o["loss"] for o in train_out}
    assert len(meshes) == 1 and len(losses) == 1, (meshes, losses)
    return {"world": devices, "mesh": meshes.pop(), "loss": losses.pop(),
            "sharded_params": train_out[0]["sharded"],
            "serve": _serve(devices, backend)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl",
                    help="nccl: one card a process; gloo: the CPU")
    args = ap.parse_args(argv)
    if args.backend == "nccl" and torch.cuda.device_count() < args.devices:
        print(f"nccl needs {args.devices} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = dryrun(args.devices, args.backend)
    print(f"dry run: world {out['world']}, mesh (data, model) = "
          f"{out['mesh']}, loss {out['loss']:.6f}, "
          f"{out['sharded_params']} sharded parameters; serving mesh "
          f"{out['serve']['members']}, group {out['serve']['group']}, "
          f"regions {out['serve']['regions']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
