"""PyTorch port, the kernels as ``torch.library`` ops (ops/library.py) on
the CPU, at B 2, nx 10, hidden 8, D 5, V 2, K 3 (the LEM at T 3, N 6,
hidden 4), float32:

* ``torch.library.opcheck`` (schema, fake implementation, autograd
  registration, AOT dispatch with dynamic shapes) of each op's CPU and fake
  implementations: the pair's forward with and without the stash and its
  backward, the layer's forward and backward at both switch settings, each
  in the three ``mp_precision`` modes, and the LEM's forward with and
  without the stash and its backward;
* each op's CPU implementation returns its plain version's values;
* each op's CUDA implementation calls its kernel function (a spy here,
  where there is no card) with the op's arguments, never a plain version,
  and returns the kernel's outputs in the op's arity (the backwards' flat
  gradients the very tensor the kernel's views share);
* the ``autograd.Function``s reach the ops.
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch.ops import lem_scan, library, mp_layer, mp_pair

from _torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

B, NX, H, D, V, K = 2, 10, 8, 5, 2, 3
T, N, HL = 3, 6, 4
MODES = ("float32", "bfloat16", "bfloat16s")


def _mp_args(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    idx = torch.randint(0, NX, (NX, K), generator=g)
    mask = (torch.rand(NX, K, generator=g) > 0.2).float()
    shapes = mp_layer._weight_shapes(H, D, V)
    weights = lambda: [r(*s) * 0.3 for s in shapes]  # noqa: E731
    return dict(h=r(B, NX, H), u=r(B, NX, D), px=r(B, NX, 1), v=r(B, NX, V),
                idx=idx, mask=mask, Wg=weights(), Wl=weights(),
                g=r(B, NX, H))


def _lem_args(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return dict(gx=r(T, N, 3 * HL), zx=r(T, N, HL), y0=r(N, HL),
                z0=r(N, HL), wy=r(HL, 3 * HL) * 0.5, wzz=r(HL, HL) * 0.5)


def _pair_fwd(a, stash, mode):
    return (a["h"], a["u"], a["px"], a["v"], a["idx"], a["mask"], a["Wg"],
            a["Wl"], stash, mode)


def _pair_bwd(a, mode):
    return (a["h"], a["u"], a["px"], a["v"], a["idx"], a["mask"], a["Wg"],
            a["Wl"], a["g"], mode)


def _layer_fwd(a, act, mode):
    return (a["h"], a["u"], a["px"], a["v"], a["idx"], a["mask"], a["Wl"],
            act, act, mode)


def _layer_bwd(a, act, mode):
    return (a["h"], a["u"], a["px"], a["v"], a["idx"], a["mask"], a["Wl"],
            a["g"], act, act, mode)


def _lem_bwd(a, dt=0.7):
    _, _, ys, zs = lem_scan.lem_scan_plain(*a.values(), dt=dt, stash=True)
    g = torch.Generator().manual_seed(9)
    return (*a.values(), ys, zs, torch.randn(N, HL, generator=g),
            torch.randn(N, HL, generator=g), dt)


CASES = (
    [(f"pair_fwd-stash{s}-{m}", "pair_fwd", lambda s=s, m=m: _pair_fwd(
        _mp_args(), s, m)) for s in (False, True) for m in MODES]
    + [(f"pair_bwd-{m}", "pair_bwd", lambda m=m: _pair_bwd(_mp_args(), m))
       for m in MODES]
    + [(f"layer_fwd-act{a}-{m}", "layer_fwd", lambda a=a, m=m: _layer_fwd(
        _mp_args(), a, m)) for a in (False, True) for m in MODES]
    + [(f"layer_bwd-act{a}-{m}", "layer_bwd", lambda a=a, m=m: _layer_bwd(
        _mp_args(), a, m)) for a in (False, True) for m in MODES]
    + [(f"lem_fwd-stash{s}", "lem_fwd", lambda s=s: (
        *_lem_args().values(), 0.7, s)) for s in (False, True)]
    + [("lem_bwd", "lem_bwd", lambda: _lem_bwd(_lem_args()))])


@pytest.mark.parametrize("op,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_opcheck(op, args):
    torch.library.opcheck(getattr(torch.ops.msmp, op).default, args())


def _plain(op, args):
    """The plain version of ``op`` on ``args``, in the op's arity."""
    a = list(args)
    if op == "pair_fwd":
        out = mp_pair.fused_gated_pair_plain(*a)
        return out if a[8] else (out,)
    if op == "pair_bwd":
        dh, dwg, dwl = mp_pair.fused_gated_pair_bwd_plain(*a)
        return dh, torch.cat([w.reshape(-1) for w in dwg + dwl])
    if op == "layer_fwd":
        return (mp_layer.fused_mp_layer_plain(*a),)
    if op == "layer_bwd":
        dh, dws = mp_layer.fused_mp_layer_bwd_plain(*a)
        return dh, torch.cat([w.reshape(-1) for w in dws])
    if op == "lem_fwd":
        return lem_scan.lem_scan_plain(*a[:6], dt=a[6], stash=a[7])
    return lem_scan.lem_scan_bwd_plain(*a[:10], dt=a[10])


@pytest.mark.parametrize("op,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cpu_implementation_is_the_plain_version(op, args):
    a = args()
    got = getattr(torch.ops.msmp, op)(*a)
    got = got if isinstance(got, tuple) else (got,)
    want = _plain(op, a)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x in got[len(want):]:  # the stash outputs of a stash-free call
        assert x.numel() == 0


def _spies(monkeypatch):
    """Replace every kernel function by a recording spy that returns its
    plain version's values (as views of one flat tensor, as the kernels'
    backwards do), and every plain version by a failure."""
    calls = []

    def spy(name, plain, split=None):
        def fn(*a, **k):
            calls.append((name, a, k))
            out = plain(*a, **k)
            return split(out) if split else out
        return fn

    def as_views(dh, *tuples):
        flat = torch.cat([w.reshape(-1) for t in tuples for w in t])
        return (dh, *mp_layer._split_grads(flat, H, D, V, len(tuples)))

    plains = {
        (mp_pair, "fused_gated_pair_kernel"): mp_pair.fused_gated_pair_plain,
        (mp_pair, "fused_gated_pair_bwd_kernel"):
            mp_pair.fused_gated_pair_bwd_plain,
        (mp_layer, "fused_mp_layer_kernel"): mp_layer.fused_mp_layer_plain,
        (mp_layer, "fused_mp_layer_bwd_kernel"):
            mp_layer.fused_mp_layer_bwd_plain,
        (lem_scan, "lem_scan_kernel"): lem_scan.lem_scan_plain,
        (lem_scan, "lem_scan_bwd_kernel"): lem_scan.lem_scan_bwd_plain}
    for (mod, name), plain in plains.items():
        split = (lambda o: as_views(*o)) if name.endswith("bwd_kernel") \
            and mod is not lem_scan else None
        monkeypatch.setattr(mod, name, spy(name, plain, split))

    def refuse(*a, **k):
        raise AssertionError("a CUDA implementation ran a plain version")

    for mod, name in ((mp_pair, "fused_gated_pair_plain"),
                      (mp_pair, "fused_gated_pair_bwd_plain"),
                      (mp_layer, "fused_mp_layer_plain"),
                      (mp_layer, "fused_mp_layer_bwd_plain"),
                      (lem_scan, "lem_scan_plain"),
                      (lem_scan, "lem_scan_bwd_plain")):
        monkeypatch.setattr(mod, name, refuse)
    return calls


KERNEL_OF = {"pair_fwd": "fused_gated_pair_kernel",
             "pair_bwd": "fused_gated_pair_bwd_kernel",
             "layer_fwd": "fused_mp_layer_kernel",
             "layer_bwd": "fused_mp_layer_bwd_kernel",
             "lem_fwd": "lem_scan_kernel", "lem_bwd": "lem_scan_bwd_kernel"}


@pytest.mark.parametrize("op,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cuda_implementation_calls_the_kernel(op, args, monkeypatch):
    a = args()
    want = _plain(op, a)
    cuda_impl = library.IMPLS[op].cuda
    calls = _spies(monkeypatch)
    got = cuda_impl(*a)
    assert [c[0] for c in calls] == [KERNEL_OF[op]]
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == {"pair_fwd": 3, "pair_bwd": 2, "layer_fwd": 1,
                        "layer_bwd": 2, "lem_fwd": 4, "lem_bwd": 6}[op]
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    if op in ("pair_bwd", "layer_bwd"):
        assert got[1]._base is None  # the views' own flat tensor


def test_autograd_functions_reach_the_ops():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "msmp":
                self.ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    a = _mp_args()
    h = a["h"].requires_grad_()
    la = {k: v.requires_grad_() for k, v in _lem_args().items()}
    with Seen() as seen:
        mp_pair.fused_gated_pair(h, a["u"], a["px"], a["v"], a["idx"],
                                 a["mask"], a["Wg"], a["Wl"]).sum().backward()
        mp_layer.fused_mp_layer(h, a["u"], a["px"], a["v"], a["idx"],
                                a["mask"], a["Wl"]).sum().backward()
        sum(x.sum() for x in lem_scan.lem_scan(*la.values(), dt=0.7)
            ).backward()
    assert seen.ops == ["pair_fwd", "pair_bwd", "layer_fwd", "layer_bwd",
                        "lem_fwd", "lem_bwd"]
    assert np.isfinite(h.grad.numpy()).all()


def test_the_schemas_are_the_registered_ones():
    for op, schema in library.SCHEMAS.items():
        assert str(getattr(torch.ops.msmp, op).default._schema) == \
            f"msmp::{op}{schema}"
