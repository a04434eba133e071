"""The launch plan of K14 (Adam) and K15 (LAMB), ``ops/multi_tensor_cuda.
plan``: a pure Python function of the list's sizes, checked on the CPU at
GPT-2-small's 148 leaves, BERT-large's 302 and a ragged list; the
wrappers' grouping of a list into launches and their cache of a list's
layout. The card tests hold the kernels' bits under forced plans."""

import subprocess
import sys
from unittest import mock

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import multi_tensor_cuda as mt
from apex_tpu_torch.transformer.testing import (BertModel, GPTModel,
                                                TransformerConfig)

H100_SMS = 132
# the tensors a K14 or K15 launch takes (multi_tensor_list_capacity) where
# the toolkit is CUDA 12.1 or later, and where it is older
CAP_12_1, CAP_4K = 737, 85


def _leaf_numels(model_cls, hidden, layers, vocab, positions):
    """The model's parameter sizes in the optimizer's list order, at
    ``hidden`` (built narrow, 48 wide, and each width mapped: 48 to
    ``hidden``, 144 to 3 ``hidden``, 192 to 4 ``hidden``)."""
    cfg = TransformerConfig(hidden_size=48, num_attention_heads=3,
                            num_layers=layers, vocab_size=vocab,
                            max_position_embeddings=positions)
    wide = {48: hidden, 144: 3 * hidden, 192: 4 * hidden}
    out = []
    for p in model_cls(cfg, device="cpu").parameters():
        n = 1
        for d in p.shape:
            n *= wide.get(d, d)
        out.append(n)
    return out


LISTS = {
    # GPT-2 small: 12 x 768, vocab 50304, 1024 positions
    "gpt2": lambda: _leaf_numels(GPTModel, 768, 12, 50304, 1024),
    # BERT-large: 24 x 1024, vocab 30592, 512 positions, both heads
    "bert_large": lambda: _leaf_numels(BertModel, 1024, 24, 30592, 512),
    # ragged: scalar tails, an empty leaf, a two-chunk leaf, a large one
    "ragged": lambda: [1, 3, 767, 768, 4099, 0, 300, mt.CHUNK + 5, 561,
                       3 * mt.CHUNK + 7, 1100 * 1000, 1000],
}


@pytest.fixture(scope="module", params=sorted(LISTS))
def numels(request):
    return request.param, LISTS[request.param]()


def test_the_lists_have_the_published_sizes():
    gpt2, bert = LISTS["gpt2"](), LISTS["bert_large"]()
    assert (len(gpt2), sum(gpt2)) == (148, 124_475_904)
    assert (len(bert), sum(bert)) == (302, 336_297_858)


def _plan(kind, numels, resident=2):
    return mt.plan(kind, numels, H100_SMS, resident)


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_the_grid_is_every_block_the_card_holds(numels, kind, resident):
    """K15's cooperative grid is every resident block; K14's too, but at
    most one block a tile."""
    _, sizes = numels
    pl = _plan(kind, sizes, resident)
    full = H100_SMS * resident
    tiles = sum(mt.tiles(x) for x in sizes)
    assert pl == mt.Plan(full if kind == "lamb" else min(full, tiles))
    assert _plan(kind, [1] * 3, resident).grid \
        == (full if kind == "lamb" else 3)


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_one_launch_a_step_at_these_lists(numels, kind):
    """The launches a step the wrappers make: one list group a dtype
    pair, ``list_capacity()`` tensors a group (GPT-2-small and BERT-large
    take one; two where the list mixes parameter dtypes)."""
    _, sizes = numels
    assert len(mt._list_groups(list(range(len(sizes))), CAP_12_1)) == 1
    pairs = [(torch.float32, torch.float32)] * len(sizes)
    if kind == "lamb":
        pairs[-1] = (torch.float32, torch.bfloat16)
    launches = sum(len(mt._list_groups(idx, CAP_12_1))
                   for _, idx in mt._by_dtype(lambda i: pairs[i],
                                              len(sizes)))
    assert launches == (1 if kind == "adam" else 2)


@pytest.mark.parametrize("cap", [CAP_12_1, CAP_4K])
def test_a_list_longer_than_a_launch_takes_groups(cap):
    idx = list(range(2 * cap + 1))
    assert [len(g) for g in mt._list_groups(idx, cap)] == [cap, cap, 1]


def test_the_capacity_is_the_built_kernels():
    """The wrappers group by the library's own capacity, asked once."""
    lib = mock.Mock()
    lib.multi_tensor_list_capacity.return_value = CAP_4K
    with mock.patch.object(_build, "load", return_value=lib) as load, \
            mock.patch.object(mt, "_list_cap", []):
        assert mt.list_capacity() == mt.list_capacity() == CAP_4K
    assert load.call_count == 1


def test_a_layout_asks_the_plan_once():
    """The wrappers keep a list's plan and chunks by its layout: the same
    sizes ask :func:`plan` once, other sizes or dtypes again, and a plan
    patched in is asked (the card tests force plans that way)."""
    import numpy as np

    dev = torch.device("cuda", 0)
    asked = []

    def counted(*a):
        asked.append(a)
        return mt.Plan(5)

    sizes = np.array([3, mt.CHUNK + 1, 0], dtype=np.int64)
    with mock.patch.object(mt, "resident", return_value=(2, H100_SMS)), \
            mock.patch.object(mt, "_layouts", {}), \
            mock.patch.object(mt, "plan", counted):
        for _ in range(3):
            got = mt._layout("lamb", sizes, torch.float32, torch.float32,
                             dev)
        assert got == (mt.Plan(5), 3) and len(asked) == 1
        assert asked[0] == ("lamb", [3, mt.CHUNK + 1, 0], H100_SMS, 2)
        mt._layout("lamb", sizes[:2], torch.float32, torch.float32, dev)
        mt._layout("lamb", sizes, torch.float32, torch.bfloat16, dev)
        assert len(asked) == 3
        with mock.patch.object(mt, "plan", lambda *a: mt.Plan(1)):
            assert mt._layout("lamb", sizes, torch.float32, torch.float32,
                              dev)[0] == mt.Plan(1)


def test_the_plan_is_pure_python_and_repeats(numels):
    """No CUDA: the library never loads and no device is asked; the same
    list gets the same plan."""
    _, sizes = numels
    with mock.patch.object(_build, "load", side_effect=AssertionError), \
            mock.patch.object(torch.cuda, "get_device_properties",
                              side_effect=AssertionError):
        a = [_plan(k, sizes) for k in ("adam", "lamb")]
        b = [_plan(k, list(sizes)) for k in ("adam", "lamb")]
    assert a == b


def test_the_plan_module_imports_no_cuda_library():
    code = ("import sys; from apex_tpu_torch.ops import _build, "
            "multi_tensor_cuda as mt; mt.plan('lamb', [768, 70000], 132, 1); "
            "assert not _build._libs; assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
