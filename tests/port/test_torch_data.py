"""Port parity of the input pipeline and the examples' real-data paths:
``apex_tpu_torch.data`` against ``apex_tpu.data`` on a small image tree
written here with Pillow, and ``--resume`` of the ImageNet example.

* ``prefetch`` gives JAX's batches bit for bit: the train transform
  (random resized crop and flip from the per-sample seeded rng) and the
  eval transform, unsharded and as each rank of ``shard=(r, 2)``;
* the ImageNet example's ``make_loader`` gives JAX's ``make_loader``
  batches (as NCHW channels_last views of the same NHWC arrays), its
  ``main`` takes the class count from the folder and trains on it, and the
  DCGAN example's image-folder batches are JAX's pipeline's (``eval_
  transform(isize, isize)``, epochs cycled, ``[0, 1) -> [-1, 1)``) and it
  trains on them;
* ``--resume``: one epoch, then a resumed second, ends with the
  parameters, running stats and amp state of two straight epochs, bit for
  bit (resnet18 at width 8, synthetic data, ``--deterministic``).
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from apex_tpu import data as jdata
from apex_tpu_torch import data as tdata
from apex_tpu_torch.examples import dcgan as tdcgan
from apex_tpu_torch.examples import imagenet as timagenet
from examples.imagenet import main_amp as jimagenet

torch.set_num_threads(2)

CLASSES = ("cat", "dog", "eel")
PER_CLASS = 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/train/<class>/ and root/val/<class>/ images of mixed sizes,
    PNG and JPEG, from a numpy seed."""
    root = tmp_path_factory.mktemp("imagefolder")
    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        for c in CLASSES:
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(PER_CLASS):
                h, w = rs.randint(24, 90, size=2)
                img = Image.fromarray(rs.randint(0, 256, (h, w, 3),
                                                 dtype=np.uint8))
                img.save(d / f"{i}.{'png' if i % 2 else 'jpg'}")
            (d / "notes.txt").write_text("not an image")
    return str(root)


def _batches(mod, ds, tf, **kw):
    return list(mod.prefetch(ds, 4, tf, num_workers=3, **kw))


def _equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_prefetch_matches_jax_bit_for_bit(tree, train, shard):
    root = os.path.join(tree, "train")
    jds, tds = jdata.ImageFolder(root), tdata.ImageFolder(root)
    assert tds.classes == list(CLASSES) and tds.samples == jds.samples
    make = (lambda m: m.train_transform(32)) if train else (
        lambda m: m.eval_transform(40, 32))
    kw = dict(shuffle=train, drop_last=True, seed=3, epoch=1, shard=shard)
    _equal(_batches(tdata, tds, make(tdata), **kw),
           _batches(jdata, jds, make(jdata), **kw))


def test_prefetch_carries_a_decode_error_to_the_consumer(tree, tmp_path):
    bad = tmp_path / "one" / "x.png"
    bad.parent.mkdir()
    bad.write_bytes(b"not a png")
    ds = tdata.ImageFolder(str(tmp_path))
    with pytest.raises(Exception):
        list(tdata.prefetch(ds, 1, tdata.eval_transform(8, 8)))


def _args(**kw):
    base = dict(data=None, synthetic=False, batch_size=4, image_size=32,
                num_classes=3, deterministic=True, steps=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_imagenet_loader_matches_jax(tree, train):
    args = _args(data=tree)
    tloader, tsteps = timagenet.make_loader(args, None, "cpu", train=train,
                                            epoch=1)
    jloader, jsteps = jimagenet.make_loader(args, None, train=train, epoch=1)
    assert tsteps == jsteps == len(CLASSES) * PER_CLASS // 4
    got = []
    for im, lab in tloader:
        assert im.is_contiguous(memory_format=torch.channels_last)
        assert lab.dtype == torch.int64
        got.append((im.permute(0, 2, 3, 1).numpy(), lab.numpy()))
    _equal(got, list(jloader))


def test_imagenet_main_trains_on_the_folder(tree, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt.pt")
    loss = timagenet.main([tree, "--arch", "resnet18", "--num-filters", "8",
                           "-b", "4", "--image-size", "32", "--device", "cpu",
                           "--deterministic", "--checkpoint", ckpt,
                           "--print-freq", "1"])
    assert np.isfinite(loss)
    assert "3 classes under" in capsys.readouterr().out
    rec = torch.load(ckpt, weights_only=False)
    assert rec["epoch"] == 1 and rec["params"]["fc.weight"].shape == (3, 64)


def test_dcgan_folder_batches_match_jax_pipeline(tree):
    args = tdcgan.parse_args([os.path.join(tree, "train"), "-b", "4",
                              "--image-size", "16"])
    gen = tdcgan.real_batches(args, np.random.RandomState(0))
    got = [next(gen) for _ in range(6)]     # 18 images: two epochs and more
    ds = jdata.ImageFolder(os.path.join(tree, "train"))
    tf = jdata.eval_transform(16, 16)
    want = []
    for epoch in range(2):
        want += [images * 2.0 - 1.0 for images, _ in jdata.prefetch(
            ds, 4, tf, shuffle=True, drop_last=True, seed=0, epoch=epoch)]
    for g, w in zip(got, want[:6]):
        np.testing.assert_array_equal(g, w)
    assert got[0].min() >= -1.0 and got[0].max() < 1.0


def test_dcgan_main_trains_on_the_folder(tree):
    losses = tdcgan.main([os.path.join(tree, "train"), "--steps", "2", "-b",
                          "4", "--ngf", "4", "--ndf", "4", "--device",
                          "cpu"])
    assert np.isfinite(losses).all()


def _imagenet_state(path):
    rec = torch.load(path, weights_only=False)
    flat = {f"params/{k}": v for k, v in rec["params"].items()}
    flat.update({f"stats/{k}": v for k, v in rec["batch_stats"].items()})
    st = rec["amp_state"]
    flat.update({f"scaler{i}/{f}": getattr(s, f) for i, s in
                 enumerate(st.scalers) for f in ("loss_scale", "unskipped")})
    if st.master_params is not None:
        flat.update({f"master/{k}": v for k, v in st.master_params.items()})
    for f in dataclasses.fields(st.inner):
        v = getattr(st.inner, f.name)
        f = f.name
        if isinstance(v, dict):
            flat.update({f"inner/{f}/{k}": t for k, t in v.items()})
        elif isinstance(v, torch.Tensor):
            flat[f"inner/{f}"] = v
    return rec["epoch"], flat


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_imagenet_resume_is_bit_equal_to_straight_training(tmp_path, level):
    common = ["--synthetic", "--arch", "resnet18", "--num-filters", "8",
              "-b", "2", "--steps", "2", "--image-size", "32",
              "--num-classes", "10", "--deterministic", "--device", "cpu",
              "--opt-level", level, "--print-freq", "100"]
    straight, resumed = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    timagenet.main(common + ["--epochs", "2", "--checkpoint", straight])
    timagenet.main(common + ["--epochs", "1", "--checkpoint", resumed])
    assert torch.load(resumed, weights_only=False)["epoch"] == 1
    timagenet.main(common + ["--epochs", "2", "--resume", resumed,
                             "--checkpoint", resumed])
    (ea, a), (eb, b) = _imagenet_state(straight), _imagenet_state(resumed)
    assert ea == eb == 2 and a.keys() == b.keys()
    assert "inner/count" in a and any(k.startswith("inner/momentum_buf/")
                                      for k in a)
    assert a["inner/count"].item() == 4
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
