"""The seam between the port's Python and its CUDA libraries, without nvcc.

``_build.entry_points`` reads every entry point's argument and result types
from its prototype in ``csrc/<name>.cu``; ``_build.load_library`` binds them
and ``_build.launch`` calls them. Here the parsed types are held against the
table the op modules, the tests and ``tools/swin_block_bwd_phases.py`` wrote
by hand before the prototypes were read, the parser's refusals are checked,
and the launch helper and the binding run on fake libraries.
"""

import ctypes
import types
from pathlib import Path

import pytest
import torch

from strajnet_tpu_torch import _build

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LL, SZ = ctypes.c_longlong, ctypes.c_size_t
PI = ctypes.POINTER(ctypes.c_int)

# (source, entry) -> (restype, argtypes, under an #if). Where the hand-written
# bindings set no restype (the self-tests, the phase clocks) it was ctypes'
# default, int, which is what the prototypes return.
HAND_BOUND = {
    ("window_any", "window_any_scratch_bytes"): (LL, [I] * 9, False),
    ("window_any", "window_any_launches"): (LL, [], False),
    ("window_any", "window_any_attn_plan"): (I, [I] * 6 + [PI], False),
    ("window_any", "window_any_fwd_launches"): (LL, [], False),
    ("window_any", "window_any_v2_attn_launches"): (LL, [], False),
    ("window_any", "window_any_fwd_product"): (
        I, [I] + [P] * 11 + [I] * 6 + [F, P], False),
    ("window_any", "swin_any_fwd"): (I, [P] * 18 + [I] * 8 + [F, P], False),
    ("window_any", "swin_any_bwd"): (I, [P] * 32 + [I] * 9 + [F, P], False),
    ("window_any", "attn_any_fwd"): (I, [P] * 9 + [I] * 7 + [P], False),
    ("window_any", "attn_any_bwd"): (I, [P] * 14 + [I] * 8 + [P], False),
    ("window_any", "swinv2_any_fwd"): (I, [P] * 19 + [I] * 8 + [F, P], False),
    ("window_any", "swinv2_any_bwd"): (I, [P] * 34 + [I] * 8 + [F, P], False),
    ("window_any", "swinv2_any_attn"): (I, [P] * 7 + [I] * 8 + [P], False),
    ("swin_block", "swin_block_fwd"): (I, [P] * 18 + [I] * 6 + [F, P], False),
    ("swin_block", "swin_block_fwd_scratch_bytes"): (LL, [I] * 5, False),
    ("swin_block", "swin_block_smem_bytes"): (SZ, [I], False),
    ("swin_block_bwd", "swin_block_bwd"): (
        I, [P] * 33 + [I] * 6 + [F, P], False),
    ("swin_block_bwd", "swin_block_bwd_scratch_bf16"): (LL, [I] * 5, False),
    ("swin_block_bwd", "swin_block_bwd_scratch_f32"): (LL, [I] * 4, False),
    ("swin_block_bwd", "swin_block_atb_accum"): (
        I, [P] * 3 + [I] * 2 + [LL, P], False),
    ("swin_block_bwd", "swin_block_bwd_smem_bytes"): (SZ, [I] * 2, False),
    ("swin_block_bwd", "swin_block_bwd_phase_clocks"): (I, [P], True),
    ("window_attention", "window_attention_fwd"): (
        I, [P] * 9 + [I] * 5 + [P], False),
    ("window_attention", "window_attention_fwd_scratch_bytes"): (
        LL, [I], False),
    ("window_attention", "window_attention_fwd_smem_bytes"): (SZ, [I], False),
    ("window_attention", "window_attention_bwd"): (
        I, [P] * 14 + [I] * 5 + [P], False),
    ("window_attention", "window_attention_bwd_scratch_bf16"): (
        LL, [I] * 4, False),
    ("window_attention", "window_attention_bwd_smem_bytes"): (SZ, [I], False),
    ("window_attention", "window_attention_bwd_phase_clocks"): (
        I, [P], True),
    ("decoder_tail_any", "decoder_tail_any_fwd"): (
        I, [P] * 7 + [I] * 6 + [P], False),
    ("decoder_tail_any", "decoder_tail_any_scratch_bytes"): (
        LL, [I] * 3, False),
    ("decoder_tail", "decoder_tail_fwd"): (I, [P] * 7 + [I] * 5 + [P], False),
    ("decoder_tail", "decoder_tail_scratch_bytes"): (LL, [], False),
    ("decoder_tail", "decoder_tail_smem_bytes"): (SZ, [], False),
    ("decoder_tail", "decoder_tail_phase_clocks"): (I, [P], True),
    ("warp_gather", "warp_gather_fwd"): (I, [P] * 7 + [I, LL, I, I, P], False),
    ("warp_gather", "warp_gather_bwd"): (
        I, [P] * 7 + [I, LL, I, I, I, P], False),
    ("sm90_selftest", "sm90_layout_selftest"): (I, [P] * 6, False),
    ("sm90_selftest", "sm90_blocked_selftest"): (I, [P] * 3 + [I, P], False),
    ("sm90_selftest", "sm90_tail_selftest"): (I, [P] * 6 + [I, P], False),
}


@pytest.mark.parametrize("source", sorted(
    p.stem for p in _build.CSRC.glob("*.cu")))
def test_every_source_has_entry_points(source):
    assert _build.entry_points(source)


@pytest.mark.parametrize("source,entry", sorted(HAND_BOUND),
                         ids=[fn for _, fn in sorted(HAND_BOUND)])
def test_prototype_gives_the_hand_bound_types(source, entry):
    restype, argtypes, conditional = HAND_BOUND[source, entry]
    got = _build.entry_points(source)[entry]
    assert got.restype is restype
    assert list(got.argtypes) == argtypes
    assert got.conditional == conditional


@pytest.mark.parametrize("prototype,what", [
    ("int bad_entry(const bf16* x, void* stream)", "bf16"),
    ("double bad_entry(int n)", "double"),
    ("int bad_entry(int, void* stream)", "int"),
    ("int bad_entry(int n, void (*cb)(int))", "bad_entry"),
])
def test_unreadable_prototype_raises_naming_file_and_function(prototype,
                                                               what):
    source = ('// a kernel\nextern "C" {\n\nint good(int n) { return n; }\n'
              f'{prototype} {{\n  return 0;\n}}\n\n}}  // extern "C"\n')
    with pytest.raises(ValueError, match=r"broken\.cu: .*bad_entry") as e:
        _build.parse_entry_points(source, "broken.cu")
    assert what in str(e.value)


def test_parser_reads_conditionals_comments_and_declarations():
    source = ('#define X 1\nstatic int helper() { return 0; }\n'
              'extern "C" {\n'
              '/* size_t not_an_entry(int n) { */\n'
              'long long sizes(void) { if (1) { return 2; } return 1; }\n'
              '#ifdef CLOCKS\n'
              'int clocks(long long* out) { return 0; }  // { unbalanced\n'
              '#endif\n'
              'int declared(const int* plan, float eps, size_t n);\n'
              '}  // extern "C"\n'
              'int after(int n) { return n; }\n')
    got = _build.parse_entry_points(source, "t.cu")
    assert got == {
        "sizes": _build.EntryPoint(LL, (), False),
        "clocks": _build.EntryPoint(I, (P,), True),
        "declared": _build.EntryPoint(I, (PI, F, SZ), False),
    }


def test_launch_passes_pointers_and_stream_and_raises(monkeypatch):
    """Tensors go as their data pointers, None as a null pointer, numbers as
    they are, the first tensor's current stream last; a nonzero return
    raises with the entry's name. The fake entry is a ctypes function of the
    prototype's types, so the arguments pass through ctypes' conversion."""
    entry = _build.parse_entry_points(
        'extern "C" {\nint fake_entry(const void* a, void* out, const void* '
        'mask, int n, float eps, void* stream) { return 0; }\n}\n',
        "fake.cu")["fake_entry"]
    seen, result = [], [0]

    def body(*args):
        seen.append(args)
        return result[0]

    fn = ctypes.CFUNCTYPE(entry.restype, *entry.argtypes)(body)
    lib = types.SimpleNamespace(fake_entry=fn)
    streams = []

    def current_stream(device):
        streams.append(device)
        return types.SimpleNamespace(cuda_stream=0x5150)

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    a, out = torch.zeros(8), torch.zeros(4, dtype=torch.int32)
    _build.launch(lib, "fake_entry", a, out, None, 7, 0.5)
    assert seen == [(a.data_ptr(), out.data_ptr(), None, 7, 0.5, 0x5150)]
    assert streams == [a.device]
    result[0] = 700
    with pytest.raises(RuntimeError, match="fake_entry.*CUDA error 700"):
        _build.launch(lib, "fake_entry", a, out, None, 7, 0.5)


class _FakeFunction:
    argtypes, restype = None, ctypes.c_int


@pytest.mark.parametrize("exported_clocks", [False, True])
def test_load_library_binds_every_entry_point(monkeypatch, exported_clocks):
    """Every entry of the prototypes is bound; the phase clocks (under
    ``#ifdef SWIN_PHASE_CLOCKS``) only where the build exports them."""
    names = set(_build.entry_points("decoder_tail"))
    if not exported_clocks:
        names.discard("decoder_tail_phase_clocks")

    class FakeLib:
        def __init__(self, path):
            assert path == "libdecoder_tail.so"
            for name in names:
                setattr(self, name, _FakeFunction())

    monkeypatch.setattr(_build, "build", lambda name: _build.Build(
        Path(f"lib{name}.so"), 0.0, ""))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    lib = _build.load_library.__wrapped__("decoder_tail")
    for name, entry in _build.entry_points("decoder_tail").items():
        if name in names:
            fn = getattr(lib, name)
            assert (fn.restype, fn.argtypes) == (entry.restype,
                                                 entry.argtypes)
    assert hasattr(lib, "decoder_tail_phase_clocks") == exported_clocks


def test_load_library_raises_on_a_missing_entry_point(monkeypatch):
    class FakeLib:
        def __init__(self, path):
            pass

    monkeypatch.setattr(_build, "build", lambda name: _build.Build(
        Path(f"lib{name}.so"), 0.0, ""))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    with pytest.raises(AttributeError, match="warp_gather_fwd"):
        _build.load_library.__wrapped__("warp_gather")
