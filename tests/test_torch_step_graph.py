"""The training step replayed as CUDA graphs (`repro_torch.core.step_graph`).

On the card (marker `gpu`; each test skips without a CUDA device): the
graphed step of `SingleDeviceBackend` against the eager
`make_train_step` body, bit for bit, over 8 steps with dropout on, in a
ppi-like recipe (fused, 3 layers), an amazon2m-like one (layer norm,
q > 1) and the scaled bf16 policy (with remat); two shape signatures
interleaved; an older state handed back in; a checkpoint restored
mid-run; the block-ELL wrappers' launch counters and split-partials
workspace under live graphs.

    python -m pytest -m gpu tests/test_torch_step_graph.py

On the CPU: the static state, the payload's leaves and signature, and
the eager path of a CPU backend.
"""
import pytest
import torch

from repro_torch.core.batching import batch_to_device
from repro_torch.core.engine import SingleDeviceBackend, make_train_step
from repro_torch.core.experiment import build_experiment, preset
from repro_torch.core.step_graph import (StaticState, payload_leaves,
                                         signature)
from repro_torch.kernels.block_spmm import BlockEllAdj
from repro_torch.nn.tree import tree_leaves
from repro_torch.runtime import faults


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 GPU")
    return torch.device("cuda")


# recipes: (preset, overrides)
RECIPES = {
    "ppi": ("ppi_tiny", {"model.num_layers": 3, "model.fuse_spmm": True}),
    "amazon2m": ("amazon2m_tiny", {"model.fuse_spmm": True}),
    "bf16": ("ppi_deep_tiny", {"model.fuse_spmm": True}),
}


def _experiment(name, device, **extra):
    name, sets = RECIPES[name]
    spec = preset(name)
    spec.partition.cache = False
    spec.batch.sparse_adj = True
    spec.run.eval_every = 0
    spec.run.checkpoint_dir = None
    for path, value in {**sets, **extra}.items():
        sec, field = path.split(".")
        setattr(getattr(spec, sec), field, value)
    return build_experiment(spec, device=device)


def _payloads(exp, n, device):
    out = []
    epoch = 0
    while len(out) < n:
        out += [batch_to_device(b.astuple(), device)
                for b in exp.batcher.epoch(epoch)]
        epoch += 1
    return out[:n]


def _eager(exp):
    """The `make_train_step` body on the state tree, run eagerly."""
    step = make_train_step(exp.cfg, exp.opt)

    def run(state, payload):
        keys = ["params", "opt", "rng"] + (["scale"] if "scale" in state
                                           else [])
        *new, loss, aux = step(*(state[k] for k in keys), payload)
        return dict(zip(keys, new)), loss, aux
    return run


def _same(a, b):
    """Bitwise equality of two (state, loss, aux) results."""
    (sa, la, xa), (sb, lb, xb) = a, b
    assert torch.equal(la, lb), (float(la), float(lb))
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert torch.equal(xa[k], xb[k]), k
    for u, v in zip(tree_leaves(sa), tree_leaves(sb), strict=True):
        if isinstance(u, torch.Generator):
            assert torch.equal(u.get_state(), v.get_state())
        else:
            assert u.dtype == v.dtype and torch.equal(u, v)


def _graphed(backend):
    return backend._step.__wrapped__


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_graphed_step_is_the_eager_step_bit_for_bit(cuda, recipe):
    exp = _experiment(recipe, cuda)
    assert exp.cfg.dropout > 0
    payloads = _payloads(exp, 8, cuda)
    eager, backend = _eager(exp), exp.engine.backend
    e, g = exp.engine.init_state(), exp.engine.init_state()
    for p in payloads:
        e_out, g_out = eager(e, p), backend.step(g, p)
        _same(e_out, g_out)
        e, g = e_out[0], g_out[0]
    graphs = _graphed(backend).graphs
    assert len(graphs) == 1 and all(v is not None for v in graphs.values())


@pytest.mark.gpu
def test_two_signatures_interleaved(cuda):
    """Payloads of two padded sizes (two graphs, as the K buckets of
    k_slots="auto" give) in turn, one static state between them."""
    small = _experiment("ppi", cuda)
    large = _experiment("ppi", cuda, **{"batch.node_cap": 256})
    a, b = _payloads(small, 4, cuda), _payloads(large, 4, cuda)
    payloads = [p for pair in zip(a, b) for p in pair]
    eager, backend = _eager(small), small.engine.backend
    e, g = small.engine.init_state(), small.engine.init_state()
    for p in payloads:
        e_out, g_out = eager(e, p), backend.step(g, p)
        _same(e_out, g_out)
        e, g = e_out[0], g_out[0]
    graphed = _graphed(backend)
    assert len(graphed.graphs) == 2 and len(graphed.states) == 1


@pytest.mark.gpu
def test_an_older_state_handed_back(cuda):
    """The benchmark's state_unchanged control: a step given a state
    two steps old, after which that state is still what it was."""
    exp = _experiment("ppi", cuda)
    p = _payloads(exp, 6, cuda)
    eager, backend = _eager(exp), exp.engine.backend
    e1 = eager(exp.engine.init_state(), p[0])[0]
    g1 = backend.step(exp.engine.init_state(), p[0])[0]
    kept = [t.clone() for t in tree_leaves(g1) if torch.is_tensor(t)]
    e, g = e1, g1
    for q in p[1:4]:
        e, g = eager(e, q)[0], backend.step(g, q)[0]
    _same(eager(e1, p[4]), backend.step(g1, p[4]))
    # and once more from the newest, then from a state written in place
    _same(eager(e, p[5]), backend.step(g, p[5]))
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [t for t in tree_leaves(g1) if torch.is_tensor(t)]))
    with torch.no_grad():
        e["params"]["layers"][0]["w"].mul_(0.5)
        g["params"]["layers"][0]["w"].mul_(0.5)
    _same(eager(e, p[0]), backend.step(g, p[0]))


@pytest.mark.gpu
def test_checkpoint_restore_continues_the_eager_trajectory(cuda, tmp_path):
    from repro_torch.runtime.checkpoint import CheckpointManager
    exp = _experiment("ppi", cuda)
    payloads = _payloads(exp, 8, cuda)
    eager, backend = _eager(exp), exp.engine.backend
    e = exp.engine.init_state()
    want = []
    for p in payloads:
        e, loss, _ = eager(e, p)
        want.append(loss)
    g = exp.engine.init_state()
    got = []
    for p in payloads[:4]:
        g, loss, _ = backend.step(g, p)
        got.append(loss)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, g, blocking=True)
    g = mgr.restore(exp.engine.init_state(), step=4, device=cuda)
    for p in payloads[4:]:
        g, loss, _ = backend.step(g, p)
        got.append(loss)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    _same((e, want[-1], {}), (g, got[-1], {}))


@pytest.mark.gpu
def test_launch_counters_and_workspace_under_live_graphs(cuda):
    from repro_torch.kernels import block_spmm
    small = _experiment("ppi", cuda)
    large = _experiment("ppi", cuda, **{"batch.node_cap": 512})
    backend, layers = small.engine.backend, small.cfg.num_layers
    g = small.engine.init_state()
    before = block_spmm.launch_counts()
    for n, p in enumerate(_payloads(small, 4, cuda), 1):
        g = backend.step(g, p)[0]
        torch.cuda.synchronize()
        now = block_spmm.launch_counts()
        assert now[:2] == (before[0] + n * layers, before[1] + n * layers)
    graphed = _graphed(backend)
    (first,) = [v for v in graphed.graphs.values() if v is not None]
    assert first.launches[:2] == (layers, layers)
    held = {k: (t.data_ptr(), t.numel())
            for k, t in first.workspace.items()}
    assert held                      # its launches split their sums
    shared = dict(block_spmm._WORKSPACE)
    # a larger signature captured after it, and eager launches beside
    for p in _payloads(large, 3, cuda):
        g = backend.step(g, p)[0]
    assert {k: (t.data_ptr(), t.numel())
            for k, t in first.workspace.items()} == held
    for k, t in first.workspace.items():
        assert all(s is not t for s in block_spmm._WORKSPACE.values())
    assert all(block_spmm._WORKSPACE.get(k) is t for k, t in shared.items()
               if k != (torch.cuda.current_device(),
                        graphed.stream.cuda_stream))


@pytest.mark.gpu
def test_a_poisoned_batch_reaches_the_replayed_step(cuda):
    """The step.nonfinite_loss fault poisons the payload before it is
    copied into the graph, at every step, not only at the capture."""
    exp = _experiment("ppi", cuda)
    backend = exp.engine.backend
    g = exp.engine.init_state()
    payloads = _payloads(exp, 4, cuda)
    for p in payloads[:3]:
        g, loss, _ = backend.step(g, p)
        assert torch.isfinite(loss)
    plan = faults.FaultPlan(
        rules={"step.nonfinite_loss": faults.FaultRule(at=(0,))})
    with faults.fault_scope(plan):
        _, loss, _ = backend.step(g, payloads[3])
    assert not torch.isfinite(loss)


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------
def test_static_state_reloads_only_what_it_did_not_return():
    leaves = [torch.arange(6.0).view(2, 3), torch.tensor(3, dtype=torch.int32),
              torch.ones(4), torch.zeros((), dtype=torch.int32)]
    st = StaticState(signature(leaves), leaves, "cpu")
    assert set(st.flats) == {torch.float32, torch.int32}
    # each leaf on a 512-byte boundary: 6 + 122, 4 + 124 fp32; 1 + 127, 1
    assert [f.numel() for f in st.flats.values()] == [256, 256]
    assert all((v.data_ptr() - st.flats[v.dtype].data_ptr()) % 512 == 0
               for v in st.views)
    assert st.sig == signature(leaves)
    assert [v.shape for v in st.views] == [t.shape for t in leaves]
    assert not st.holds(leaves)
    st.load(leaves)
    assert all(torch.equal(v, t) for v, t in zip(st.views, leaves))
    out = st.fresh()
    assert all(torch.equal(v, t) for v, t in zip(out, leaves))
    assert all(o.data_ptr() != v.data_ptr() for o, v in zip(out, st.views))
    # the returned copy, unmodified, is what the static state holds
    assert st.holds(out) and not st.holds(leaves)
    st.views[0].fill_(-1.0)
    st.load(out)
    assert float(st.views[0][0, 0]) == -1.0
    # written in place, or other tensors: copied in
    out[2].add_(1.0)
    assert not st.holds(out)
    st.load(out)
    assert torch.equal(st.views[0], leaves[0])
    assert torch.equal(st.views[2], torch.full((4,), 2.0))
    st.load(leaves)
    assert all(torch.equal(v, t) for v, t in zip(st.views, leaves))
    # a second fresh copy is new memory again, the first one unchanged
    first = st.fresh()
    st.views[2].fill_(9.0)
    second = st.fresh()
    assert torch.equal(first[2], torch.ones(4))
    assert torch.equal(second[2], torch.full((4,), 9.0))


def test_payload_leaves_and_signature():
    exp = _experiment("ppi", "cpu")
    b1, b2 = _payloads(exp, 2, "cpu")
    assert isinstance(b1[0], BlockEllAdj)
    leaves = payload_leaves(b1)
    assert len(leaves) == 6 + len(b1) - 1
    assert signature(leaves) == signature(payload_leaves(b2))
    large = _experiment("ppi", "cpu", **{"batch.node_cap": 256})
    b3 = _payloads(large, 1, "cpu")[0]
    assert signature(payload_leaves(b3)) != signature(leaves)
    state = exp.engine.init_state()
    sig = signature(tree_leaves(state))
    assert ("generator", torch.device("cpu")) in sig


def test_the_cpu_backend_runs_the_body_eagerly():
    exp = _experiment("ppi", "cpu")
    backend = exp.engine.backend
    assert isinstance(backend, SingleDeviceBackend)
    assert not hasattr(backend._step, "graphs")
    state = exp.engine.init_state()
    kept = [t.clone() for t in tree_leaves(state) if torch.is_tensor(t)]
    p = _payloads(exp, 1, "cpu")[0]
    e_out = _eager(exp)(exp.engine.init_state(), p)
    _same(e_out, backend.step(state, p))
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [t for t in tree_leaves(state) if torch.is_tensor(t)]))


def test_the_fault_wrapper_keeps_the_step_it_wraps():
    def step(*args):
        return args
    wrapped = faults.wrap_step_faults(step)
    assert wrapped.__wrapped__ is step
    assert wrapped(1, 2) == (1, 2)


@pytest.mark.parametrize("opt", ["adamw", "sgd", "sgd_momentum"])
def test_tree_builder_rebuilds_the_state_trees(opt):
    """`tree_builder` (what a replay rebuilds its state with, and what
    `tree_unflatten` is made of) against the tree it was made from:
    the same containers, keys and leaves in `tree_leaves` order."""
    from repro_torch.core.gcn import GCNConfig, init_params
    from repro_torch.nn import optim
    from repro_torch.nn.tree import tree_builder, tree_map
    cfg = GCNConfig(in_dim=5, hidden_dim=4, out_dim=3, num_layers=3)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    make = {"adamw": optim.adamw(1e-2), "sgd": optim.sgd(1e-2),
            "sgd_momentum": optim.sgd(1e-2, momentum=0.9)}[opt]
    state = {"params": params, "opt": make.init(params),
             "rng": torch.Generator(),
             "scale": {"scale": torch.tensor(2.0), "good": torch.tensor(0)}}
    leaves = [t.clone() if torch.is_tensor(t) else t
              for t in tree_leaves(state)]
    build = tree_builder(state)
    for _ in range(2):                 # one builder, many trees
        built = build(iter(leaves))
        assert all(a is b for a, b in zip(tree_leaves(built), leaves,
                                          strict=True))
        assert tree_map(lambda t: type(t).__name__, built) == \
            tree_map(lambda t: type(t).__name__, state)
        assert type(built["opt"]) is type(state["opt"])
