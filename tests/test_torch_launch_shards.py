"""The launchers on a mesh make each rank's shards only, on two gloo
ranks on the CPU (one spawned world for the module).

At a reduced dense config (qwen2.5-3b: q/k/v biases, f32) and a reduced
MoE/MLA config (deepseek-v2-236b at 3 layers: a lead dense layer and
two stacked MoE layers with routed and shared experts, latent
attention), on a 2x1 mesh (FSDP over data) and a 1x2
mesh (tensor-parallel over model):

- `train(..., steps=0)` and `serve.decode_state` give local shards,
  dtypes, global shapes and placements bitwise equal to today's route,
  the whole state drawn on every rank and placed by `distribute`
  (`place_state(init_state(0))`, `distribute(init_lm(0))` and the
  cache's zeros); Meta-SGD's α too (dense config);
- an injected φ or injected weights place to the same shards;
- a `TorchDispatchMode` recorder shows that no tensor larger than the
  largest leaf of one draw unit (one layer's leaf, or a leaf drawn on
  its own such as the embedding) counted in f32 is made during the
  sharded init, and that no collective runs there, where today's route
  makes a whole stacked leaf and runs broadcasts and scatters;
- one train step from the sharded state gives the same loss, bitwise,
  as one from the injected whole φ (dense config, 1x2 mesh);
- the dense 1x2 step in a world on `staged_gloo` (the backend that two
  ranks on one card step through) is the gloo world's, bitwise;
- `rules.cut`, the local cut, gives the shards `distribute_tensor`
  scatters, on dims that do not divide.

Serial time: ~20 s (one spawn of two ranks).
"""
import dataclasses

import pytest
import torch

import torchdist
from repro_torch.utils.pytree import tree_leaves

CONFIGS = {"dense": "qwen2.5-3b", "moe_mla": "deepseek-v2-236b"}
MESHES = [(2, 1), (1, 2)]
DECODE = dict(batch=2, seq=16)
COLLECTIVE_NS = ("c10d.", "_c10d_functional.", "c10d_functional.")


class Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest tensor an op makes on a real device (a DTensor counts
    its local shard), the collectives dispatched, and the ops that run
    on DTensors."""

    def __init__(self):
        super().__init__()
        self.largest, self.collectives, self.dtensor_ops = 0, [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        name = str(func)
        if name.startswith(COLLECTIVE_NS):
            self.collectives.append(name)
        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops.add(name)
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                local = t._local_tensor if isinstance(t, DTensor) else t
                if local.device.type != "meta":
                    self.largest = max(self.largest,
                                       local.numel() * local.element_size())
        return out


def unit_bound(cfg) -> int:
    """Bytes of the largest leaf of one draw unit, counted in f32 (the
    staging `dense_init` draws in)."""
    from repro_torch.models.layers import Rng
    from repro_torch.models.lm import init_units
    from repro_torch.utils.pytree import tree_leaves
    return max(x.numel() * 4 for _, unit, _ in init_units(Rng(0, "meta"), cfg)
               for x in tree_leaves(unit))


def same_shards(a, b) -> bool:
    """Every leaf a DTensor with equal placements, global shape, dtype
    and local values (bitwise); other leaves equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.utils.pytree import tree_flatten
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    if ta != tb:
        return False
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
            continue
        if not (isinstance(x, DTensor) and isinstance(y, DTensor)):
            return False
        if (x.placements != y.placements or x.shape != y.shape
                or x.dtype != y.dtype
                or not torch.equal(x.to_local(), y.to_local())):
            return False
    return True


def recorded(fn):
    with Recorder() as rec:
        out = fn()
    return out, {"largest": rec.largest, "collectives": rec.collectives,
                 "dtensor_ops": sorted(rec.dtensor_ops)}


def clone(tree):
    from repro_torch.utils.pytree import tree_map
    return tree_map(torch.clone, tree)


def check_boxes(mesh):
    """`rules.cut` against `distribute_tensor` on dims that do not
    divide, and on one that is shorter than the mesh dim."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import P, cut, placements
    out = []
    for shape, spec in (((5, 3), P("data", None)), ((3, 7), P(None, "model")),
                        ((1, 4), P("data", "model"))):
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        pl = placements(spec, mesh)
        out.append(torch.equal(cut(x, pl, mesh).to_local(),
                               distribute_tensor(x, mesh, pl).to_local()))
    return all(out)


def config(kind):
    """The reduced config; the MoE/MLA one at 3 layers, so that its MoE
    layers stack two repetitions as the dense one does."""
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(CONFIGS[kind]))
    return dataclasses.replace(cfg, num_layers=3) if kind == "moe_mla" \
        else cfg


def shards_worker(rank, staged_store):
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import serve, train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_lm
    from repro_torch.sharding.rules import (cache_pspecs, distribute,
                                            param_pspecs)
    shape = tl.reduced_shape(INPUT_SHAPES["train_4k"])
    res = {}
    for data, model in MESHES:
        mesh = make_host_mesh(data, model, device_type="cpu")
        tag = f"{data}x{model}"
        res[("boxes", tag)] = check_boxes(mesh)
        for kind in CONFIGS:
            cfg = config(kind)
            _, init_state, _, _ = make_train_step(cfg)
            old, old_rec = recorded(lambda: tl.place_state(
                init_state(0, device="cpu"), mesh))
            whole = init_state(0, device="cpu")
            (new, _), new_rec = recorded(lambda: tl.train(
                cfg, shape, steps=0, device="cpu", mesh=mesh))
            inj, _ = tl.train(cfg, shape, steps=0, device="cpu", mesh=mesh,
                              phi=clone(whole["phi"]))
            del whole
            whole_params = init_lm(0, cfg, device="cpu")
            old_dec = (distribute(clone(whole_params), param_pspecs(
                whole_params, mesh), mesh),)
            _, old_cache = serve.decode_state(cfg, **DECODE, device="cpu")
            old_dec += (distribute(old_cache, cache_pspecs(old_cache, mesh),
                                   mesh),)
            new_dec, dec_rec = recorded(lambda: serve.decode_state(
                cfg, **DECODE, device="cpu", mesh=mesh))
            inj_dec = serve.decode_state(cfg, **DECODE, device="cpu",
                                         mesh=mesh, params=whole_params)
            res[(kind, tag)] = {
                "train_bitwise": same_shards(new, old),
                "train_injected_bitwise": same_shards(inj, new),
                "decode_bitwise": same_shards(new_dec, old_dec),
                "decode_injected_bitwise": same_shards(inj_dec, new_dec),
                "bound": unit_bound(cfg),
                "train": new_rec, "decode": dec_rec, "old": old_rec}
            if kind == "dense" and tag == "1x2":
                st, r_new = tl.train(cfg, shape, steps=1, device="cpu",
                                     mesh=mesh, log_every=10 ** 9)
                step_phi = tree_leaves(tl.full(st["phi"]))
                del st
                _, r_inj = tl.train(cfg, shape, steps=1, device="cpu",
                                    mesh=mesh, log_every=10 ** 9,
                                    phi=clone(init_state(
                                        0, device="cpu")["phi"]))
                res["step_loss"] = (r_new[0]["query_loss"],
                                    r_inj[0]["query_loss"])
                _, init_sgd, _, _ = make_train_step(cfg, algo_name="meta-sgd")
                sgd_old = tl.place_state(init_sgd(0, device="cpu"), mesh)
                sgd_new, sgd_rec = recorded(lambda: init_sgd(
                    0, device="cpu", mesh=mesh))
                res["meta_sgd"] = {"bitwise": same_shards(sgd_new, sgd_old),
                                   "collectives": sgd_rec["collectives"]}
    res["staged"] = staged_step(rank, staged_store, config("dense"), shape,
                                r_new[0]["query_loss"], step_phi)
    return res


def staged_step(rank, store, cfg, shape, loss, phi):
    """The dense 1x2 step again, in a world on `staged_gloo` (the gloo
    world ended): its loss and φ against the gloo world's, and the
    staged collectives it ran."""
    import torch.distributed as dist
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import collectives as coll
    dist.destroy_process_group()
    dist.init_process_group(coll.register_staged_gloo(),
                            store=dist.FileStore(store, 2), rank=rank,
                            world_size=2)
    coll.reset()
    st, r = tl.train(cfg, shape, steps=1, device="cpu",
                     mesh=make_host_mesh(1, 2, device_type="cpu"),
                     log_every=10 ** 9)
    calls = dict(coll.calls)
    got = tree_leaves(tl.full(st["phi"]))
    return {"loss": (r[0]["query_loss"], loss), "calls": calls,
            "phi_bitwise": all(torch.equal(a, b) for a, b in zip(got, phi))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    return torchdist.spawn_world(tmp, 2, shards_worker,
                                 str(tmp / "staged.store"))


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in MESHES])
def test_shard_box_cuts_as_distribute_tensor(ranks, tag):
    assert all(r[("boxes", tag)] for r in ranks)


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_sharded_init_is_bitwise_todays_shards(ranks, kind, tag):
    for r in ranks:
        got = r[(kind, tag)]
        assert got["train_bitwise"] and got["decode_bitwise"], got


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_injected_phi_and_params_place_to_the_same_shards(ranks, kind, tag):
    for r in ranks:
        got = r[(kind, tag)]
        assert got["train_injected_bitwise"], got
        assert got["decode_injected_bitwise"], got


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_sharded_init_makes_no_large_tensor_and_runs_no_collective(
        ranks, kind, tag):
    for r in ranks:
        got = r[(kind, tag)]
        for route in ("train", "decode"):
            rec = got[route]
            assert rec["collectives"] == [], (route, rec)
            assert rec["largest"] <= got["bound"], (route, rec, got["bound"])
            # the only op on DTensors: Adam's moments as zeros_like
            assert set(rec["dtensor_ops"]) <= {"aten.zeros_like.default"}
        # the recorder sees what today's route does
        assert got["old"]["collectives"], got["old"]
        assert got["old"]["largest"] > got["bound"], got["old"]


def test_step_from_the_sharded_state_is_the_injected_one(ranks):
    for r in ranks:
        new, inj = r["step_loss"]
        assert new == inj


def test_meta_sgd_alpha_is_cut_from_the_whole_draw(ranks):
    for r in ranks:
        assert r["meta_sgd"]["bitwise"]
        assert r["meta_sgd"]["collectives"] == []


def test_staged_gloo_step_is_the_gloo_step(ranks):
    """`StagedGloo` runs DTensor's collectives of a launcher step: the
    same loss and φ, bitwise, as the gloo world's."""
    for r in ranks:
        got = r["staged"]
        assert got["loss"][0] == got["loss"][1], got
        assert got["phi_bitwise"], got
        assert got["calls"].get("staged_all_gather", 0) > 0, got
        assert got["calls"].get("staged_all_reduce", 0) > 0, got
