"""The port's multi-device placement and the ``shard_map`` twin's
collectives (``partitioning.device_put``, ``constrain``, ``shard_map``,
``axis_index``, ``ppermute``, ``psum``, ``pmean``, ``COLLECTIVES``;
``launch/mesh.group_mesh`` and ``make_host_mesh`` over a process group) on 4
CPU ranks of a gloo process group.

One 4-rank job (``torch_ranks.run``, in a subprocess with its own
timeout) runs every check; each parametrised case below reads one.  The
gradient checks hold a body's gradients against the same function on one
device through plain autograd: a ``ppermute``'s backward is the inverse
permutation, a ``psum`` whose result is replicated passes its cotangent
through unchanged, and an input replicated over an axis gets its gradient
summed over that axis (also where the body computes a replicated output
alike on every rank)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_ranks  # noqa: E402

WORLD = 4

CODE = r'''
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch import analysis
from repro_torch import partitioning as pt
from repro_torch.launch import mesh as mesh_lib

P = pt.PartitionSpec
M22 = mesh_lib.group_mesh(("data", "model"), (2, 2), "cpu")
M14 = mesh_lib.group_mesh(("data", "model"), (1, 4), "cpu")
ME = M14.device_mesh.get_local_rank("model")
gen = torch.Generator().manual_seed(0)
X = torch.randn(4, 6, generator=gen, dtype=torch.float64)
W = torch.randn(6, generator=gen, dtype=torch.float64)
C = torch.randn(4, 6, generator=gen, dtype=torch.float64)


def close(a, b, tol=1e-12):
    err = (a - b).abs().max().item()
    assert err <= tol, err
    return err


def put(mesh, t, spec):
    return pt.device_put(t, pt.NamedSharding(mesh, spec))


def leaf(mesh, t, spec):
    return put(mesh, t, spec).detach().requires_grad_()


def grads(loss_fn, *leaves):
    return torch.autograd.grad(loss_fn(*leaves), leaves)


def mesh_from_group():
    assert M22.shape == {"data": 2, "model": 2} and M22.size == 4
    dm = M22.device_mesh
    assert dm.mesh_dim_names == ("data", "model")
    assert dm.mesh.tolist() == [[0, 1], [2, 3]]
    assert (dm.get_local_rank("data"), dm.get_local_rank("model")) \
        == divmod(RANK, 2)
    # the host mesh over a group: every rank on 'data'
    host = mesh_lib.make_host_mesh(device="cpu")
    assert host.shape == {"data": 4, "model": 1}
    assert host.device_mesh.mesh.tolist() == [[0], [1], [2], [3]]
    try:
        mesh_lib.group_mesh(("data", "model"), (2, 4), "cpu")
    except RuntimeError as e:
        assert "process group of 8 ranks, found 4" in str(e), e
    else:
        raise AssertionError("a mesh of 8 on 4 ranks was built")


def device_put_placements():
    rules = pt.make_rules(M22)
    cases = [(("batch", None), (4, 6)), (("embed", "mlp"), (4, 6)),
             ((None, "mlp"), (4, 3)), (("experts", None, "mlp"), (2, 4, 6)),
             ((None,), (5,))]
    i, j = divmod(RANK, 2)
    for axes, shape in cases:
        t = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        s = rules.sharding_for(axes, shape)
        dt = pt.device_put(t, s)
        assert isinstance(dt, DTensor) and dt.device_mesh is M22.device_mesh
        assert list(dt.placements) == s.placements(), (axes, dt.placements)
        local = t
        for k, pl in zip((i, j), s.placements()):
            if isinstance(pl, Shard):
                local = local.chunk(2, dim=pl.dim)[k]
        assert torch.equal(dt.to_local(), local), axes
        assert torch.equal(dt.full_tensor(), t), axes
    return len(cases)


def constrain_redistributes():
    rules = pt.make_rules(M22)
    t = torch.arange(24.).reshape(4, 6)
    dt = pt.device_put(t, rules.sharding_for(("batch", None), t.shape))
    with pt.use_rules(rules):
        got = analysis.count_collectives(lambda: pt.constrain(
            dt, (None, "mlp")))
        out = pt.constrain(dt, (None, "mlp"))
        assert pt.constrain(out, (None, "mlp")) is out
    assert list(out.placements) == [Replicate(), Shard(1)]
    assert torch.equal(out.full_tensor(), t)
    # data: Shard(0) -> Replicate is an all-gather of this rank's 2 x 6
    assert got == {"all-gather": (1, 2 * 6 * 4)}, got
    return got


def constrain_refuses_plain():
    with pt.use_rules(pt.make_rules(M22)):
        try:
            pt.constrain(torch.ones(4, 4), ("batch", None))
        except TypeError as e:
            assert "plain Tensor on a mesh of 4 devices" in str(e)
        else:
            raise AssertionError("a plain tensor passed constrain")


def _permute(perm):
    f = pt.shard_map(lambda x: pt.ppermute(x, "model", perm), M14,
                     in_specs=(P("model"),), out_specs=P("model"))
    return f


def ppermute_forward():
    x = torch.arange(4.)[:, None].repeat(1, 3)          # row i = i
    cyc = _permute([(i, (i + 1) % 4) for i in range(4)])(put(M14, x,
                                                            P("model")))
    assert torch.equal(cyc.to_local(), torch.full((1, 3), float((ME - 1) % 4)))
    up = _permute([(i, i + 2) for i in range(2)])(put(M14, x, P("model")))
    want = torch.full((1, 3), float(ME - 2)) if ME >= 2 else torch.zeros(1, 3)
    assert torch.equal(up.to_local(), want)


def ppermute_backward():
    def dist_loss(x, c):
        y = _permute([(i, i + 1) for i in range(3)])(x)
        return ((y * c) ** 2).sum().full_tensor()

    def one_loss(x, c):
        y = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
        return ((y * c) ** 2).sum()

    gx, gc = grads(dist_loss, leaf(M14, X, P("model")),
                   leaf(M14, C, P("model")))
    rx, rc = grads(one_loss, X.clone().requires_grad_(),
                   C.clone().requires_grad_())
    assert torch.equal(gx.full_tensor()[-1], torch.zeros(6))   # sent nowhere
    return close(gx.full_tensor(), rx), close(gc.full_tensor(), rc)


def psum_replicated_identity():
    f = pt.shard_map(lambda x: pt.psum(x, "model"), M14,
                     in_specs=(P("model"),), out_specs=P())
    (g,) = grads(lambda x: (f(x) ** 2).sum().full_tensor(),
                 leaf(M14, X, P("model")))
    (r,) = grads(lambda x: (x.reshape(4, 1, 6).sum(0) ** 2).sum(),
                 X.clone().requires_grad_())
    return close(g.full_tensor(), r)


def replicated_input_sums():
    f = pt.shard_map(lambda x, w: x * w, M22,
                     in_specs=(P("data", "model"), P()),
                     out_specs=P("data", "model"))
    w3 = W[:3]                      # one width-3 column block's weights
    g = grads(lambda x, w: (f(x, w) ** 2).sum().full_tensor(),
              leaf(M22, X, P("data", "model")), leaf(M22, w3, P()))
    r = grads(lambda x, w: ((x.reshape(4, 2, 3) * w) ** 2).sum(),
              X.clone().requires_grad_(), w3.clone().requires_grad_())
    return [close(a.full_tensor(), b) for a, b in zip(g, r)]


def redundant_replicated_output():
    # z is computed alike on every rank and left replicated; y goes
    # through a psum: both gradients must come out single-device
    def body(x, w):
        return pt.psum((x * w).sum(0, keepdim=True), "model"), w ** 3

    f = pt.shard_map(body, M14, in_specs=(P("model"), P()),
                     out_specs=(P(), P()))

    def dist_loss(x, w):
        y, z = f(x, w)
        return ((y ** 2).sum() + z.sum()).full_tensor()

    g = grads(dist_loss, leaf(M14, X, P("model")), leaf(M14, W, P()))
    r = grads(lambda x, w: ((x * w).sum(0) ** 2).sum() + (w ** 3).sum(),
              X.clone().requires_grad_(), W.clone().requires_grad_())
    return [close(a.full_tensor(), b) for a, b in zip(g, r)]


def pmean_two_axes():
    f = pt.shard_map(lambda x: pt.pmean(x, ("data", "model")), M22,
                     in_specs=(P("data", "model"),), out_specs=P())
    x = leaf(M22, X, P("data", "model"))
    got = analysis.count_collectives(f, x)
    assert got == {"all-reduce": (2, 2 * 2 * 3 * 8)}, got
    (g,) = grads(lambda x: (f(x) ** 2).sum().full_tensor(), x)
    (r,) = grads(lambda x: (x.reshape(2, 2, 2, 3).mean((0, 2)) ** 2).sum(),
                 X.clone().requires_grad_())
    return close(g.full_tensor(), r)


def axis_index_and_bf16():
    seen = []

    def body(x):
        seen.append((pt.axis_index("data"), pt.axis_index("model")))
        return pt.psum(x, "model")

    f = pt.shard_map(body, M22, in_specs=(P(None, "model"),),
                     out_specs=P())
    t = torch.arange(8, dtype=torch.bfloat16).reshape(1, 8) + 250
    out = f(put(M22, t, P(None, "model")))
    assert seen == [divmod(RANK, 2)], seen
    want = (t.float()[:, :4] + t.float()[:, 4:]).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out.to_local(), want)


def counts_per_rank():
    def body(x):
        return pt.ppermute(x, "model", [(i, i + 1) for i in range(3)]), \
            pt.psum(x, "model")

    f = pt.shard_map(body, M14, in_specs=(P("model"),),
                     out_specs=(P("model"), P()))
    x = put(M14, X.float(), P("model"))
    got = analysis.count_collectives(f, x)
    want = {"collective-permute": (1, 24 if ME < 3 else 0),
            "all-reduce": (1, 24)}
    assert got == want, got
    return got


def collectives_outside_a_body_raise():
    try:
        pt.psum(torch.ones(2), "model")
    except RuntimeError as e:
        assert "outside a shard_map body" in str(e)
    else:
        raise AssertionError("psum outside shard_map")


for name, fn in list(globals().items()):
    if callable(fn) and name in CHECKS:
        check(name, fn)
finish()
'''

CHECKS = ("mesh_from_group", "device_put_placements",
          "constrain_redistributes", "constrain_refuses_plain",
          "ppermute_forward", "ppermute_backward",
          "psum_replicated_identity", "replicated_input_sums",
          "redundant_replicated_output", "pmean_two_axes",
          "axis_index_and_bf16", "counts_per_rank",
          "collectives_outside_a_body_raise")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    code = f"CHECKS = {CHECKS!r}\n" + CODE
    return torch_ranks.run(code, WORLD, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", CHECKS)
def test_collectives(results, name):
    torch_ranks.assert_held(results, name, WORLD)
