"""Port parity: ``utils/tb_events.py`` and ``MetricsLogger(tb=True)``
against the JAX package. With the clock and the host name pinned, the
port's event files equal the JAX writer's byte for byte, for the same
scalars and images, for ``convert_jsonl`` and for the metrics logger; the
real TensorBoard reader (installed here; neither package imports it) reads
them back."""

import json
import os

import numpy as np
import pytest

from stylemesh_tpu.utils import tb_events as jtb
from stylemesh_tpu.utils.logging import MetricsLogger as JLogger
from stylemesh_tpu_torch.utils import tb_events as ttb
from stylemesh_tpu_torch.utils.logging import MetricsLogger as TLogger

ea = pytest.importorskip(
    "tensorboard.backend.event_processing.event_accumulator")


def _pin(monkeypatch, start=1_700_000_000.0):
    """Both modules' clock ticks 0.25 s a call from ``start``; one host
    name."""
    ticks = iter(np.arange(start, start + 1e6, 0.25))
    monkeypatch.setattr(ttb.time, "time", lambda: float(next(ticks)))
    monkeypatch.setattr(ttb.socket, "gethostname", lambda: "host0")
    assert jtb.time is ttb.time and jtb.socket is ttb.socket


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _load(path):
    acc = ea.EventAccumulator(path, size_guidance={ea.SCALARS: 0, ea.IMAGES: 0})
    acc.Reload()
    return acc


def _write(mod, log_dir, images):
    w = mod.TBEventWriter(str(log_dir))
    for step, v in enumerate([3.5, 2.25, -1.0, 1e-30, 7e20]):
        w.add_scalar("Loss/train/total", v, step)
    w.add_scalar("Loss/val/style", np.float32(7.75), 2)
    for step, img in enumerate(images):
        w.add_image(f"Images/{step}", img, step)
    w.close()
    return w.path


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.random((12, 17, 3)).astype(np.float32),
            rng.integers(0, 255, (9, 5, 4), dtype=np.uint8),
            rng.random((6, 7)).astype(np.float32)]


def test_event_bytes_equal_jax(tmp_path, monkeypatch):
    """Each package's writer on its own fresh pinned clock: the same file
    name and the same bytes, for scalars and RGB, RGBA and gray images."""
    paths = []
    for mod, sub in ((ttb, "port"), (jtb, "jax")):
        _pin(monkeypatch)
        paths.append(_write(mod, tmp_path / sub, _images(0)))
    assert _bytes(paths[0]) == _bytes(paths[1])
    assert os.path.basename(paths[0]) == os.path.basename(paths[1]) == (
        "events.out.tfevents.1700000000.host0")


def test_tensorboard_reads_the_port_file(tmp_path, monkeypatch):
    import io

    from PIL import Image

    _pin(monkeypatch)
    images = _images(1)
    acc = _load(_write(ttb, tmp_path, images))
    assert set(acc.Tags()["scalars"]) == {"Loss/train/total", "Loss/val/style"}
    ev = acc.Scalars("Loss/train/total")
    assert [e.step for e in ev] == list(range(5))
    np.testing.assert_allclose([e.value for e in ev],
                               np.float32([3.5, 2.25, -1.0, 1e-30, 7e20]))
    im = acc.Images("Images/0")[0]
    assert (im.height, im.width, im.step) == (12, 17, 0)
    png = np.asarray(Image.open(io.BytesIO(im.encoded_image_string)))
    np.testing.assert_array_equal(
        png, (np.clip(images[0], 0, 1) * 255 + 0.5).astype(np.uint8))
    assert acc.Images("Images/1")[0].width == 5


def test_convert_jsonl_equals_jax(tmp_path, monkeypatch):
    recs = [{"tag": "Batch/Loss/train/total", "value": 1.5, "step": 1},
            {"tag": "Batch/Loss/train/total", "value": 0.5, "step": 2},
            {"tag": "Loss/val/content", "value": 3.0}]
    p = tmp_path / "metrics.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    monkeypatch.setattr(ttb.socket, "gethostname", lambda: "host0")
    outs = []
    for mod, sub in ((ttb, "port"), (jtb, "jax")):
        monkeypatch.setattr(ttb.time, "time", lambda: 1_700_000_000.5)
        outs.append(mod.convert_jsonl(str(p), str(tmp_path / sub)))
    assert _bytes(outs[0]) == _bytes(outs[1])
    ev = _load(outs[0]).Scalars("Batch/Loss/train/total")
    assert [(e.step, e.value) for e in ev] == [(1, 1.5), (2, 0.5)]
    # without a directory it writes beside the log
    monkeypatch.setattr(ttb.time, "time", lambda: 1_700_000_100.0)
    assert os.path.dirname(ttb.convert_jsonl(str(p))) == str(tmp_path)


def test_metrics_logger_tb_equals_jax(tmp_path, monkeypatch):
    """``MetricsLogger(tb=True)``: the batch losses, epoch means and an
    image grid land in one event file, equal to the JAX logger's; without
    ``tb`` no event file, and a logger of a rank other than 0 (no
    ``log_dir``) writes nothing."""
    monkeypatch.setattr(ttb.socket, "gethostname", lambda: "host0")
    img = np.random.default_rng(2).random((6, 10, 3)).astype(np.float32)
    paths = []
    for cls, sub in ((TLogger, "port"), (JLogger, "jax")):
        monkeypatch.setattr(ttb.time, "time", lambda: 1_700_000_000.0)
        lg = cls(str(tmp_path / sub), tb=True)
        lg.batch_losses("train", {"total": 4.0, "style": 3.0}, 1)
        lg.batch_losses("train", {"total": 2.0, "style": 1.0}, 2)
        lg.epoch_means("train", 0)
        lg.image("Images/train", img, 2)
        lg.close()
        paths.append(lg._tb.path)
    assert _bytes(paths[0]) == _bytes(paths[1])
    acc = _load(paths[0])
    assert set(acc.Tags()["scalars"]) == {
        "Batch/Loss/train/total", "Batch/Loss/train/style",
        "Loss/train/total", "Loss/train/style"}
    assert acc.Scalars("Loss/train/total")[0].value == 3.0
    assert acc.Tags()["images"] == ["Images/train"]

    lg = TLogger(str(tmp_path / "plain"))
    lg.scalar("a", 1.0, 0)
    lg.close()
    assert os.listdir(tmp_path / "plain") == ["metrics.jsonl"]
    lg = TLogger(None, tb=True)
    lg.batch_losses("train", {"total": 1.0}, 1)
    assert lg.epoch_means("train", 0) == {"total": 1.0}
    lg.close()
