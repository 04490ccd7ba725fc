"""The port's Trainer batches (`scrabblegan_torch.train.batches`) and
summaries (`train.metrics`) against the JAX Trainer's (CPU).

For each shape mode, bucket pairing, `io.seq_len` and wire format, a JAX
`Trainer` (built and loaded; nothing is compiled) and the port's `Batches`
load the same synthetic data set with the same seed: the fixed seed
(`seed_style`, `seed_labels`, `seed_z`) and ten batches of `_assemble` /
`assemble` are equal array for array (bitwise, dtypes included), and so is
the next one against JAX's `next_batch` (after its device_put). The summary files that
`SummaryWriter` writes for the same rows are byte-identical, `append`
included.
"""

import dataclasses

import numpy as np
import pytest

from scrabblegan_tpu.config import load_config
from scrabblegan_tpu.train.metrics import SummaryWriter as JaxSummaryWriter
from scrabblegan_torch.config import load_config as port_load_config
from scrabblegan_torch.data.synthetic import make_synthetic_dataset
from scrabblegan_torch.train.batches import Batches
from scrabblegan_torch.train.metrics import SummaryWriter
from scrabblegan_torch.train.step import METRIC_NAMES

BASE = {"shared.batch_size": "3", "io.bucket_size": "4", "shared.num_gen": "3",
        "parallel.num_devices": "1", "seed": "7"}
CASES = {
    "bucketed matched": {},
    "bucketed independent": {"parallel.bucket_pairing": "independent"},
    "padded": {"parallel.shape_mode": "padded"},
    "padded sample": {"parallel.shape_mode": "padded", "parallel.batch_mix": "sample"},
    "padded sample independent": {"parallel.shape_mode": "padded",
                                  "parallel.batch_mix": "sample",
                                  "parallel.bucket_pairing": "independent"},
    "seq_len": {"io.seq_len": "2"},
    "padded seq_len": {"parallel.shape_mode": "padded", "io.seq_len": "3"},
    "float32 wire": {"parallel.transfer_dtype": "float32"},
    "padded float32 wire": {"parallel.shape_mode": "padded",
                            "parallel.transfer_dtype": "float32"},
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    read_dir, words_file, style_dir = make_synthetic_dataset(
        str(root), samples_per_bucket=4, bucket_size=4, length_weights=(1, 3, 0.5, 2))
    return {"read_dir": read_dir, "style_dir": style_dir, "words_file": words_file}


def assert_same_batch(got: dict, want: dict, where: str):
    assert sorted(got) == sorted(want), where
    for key in want:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype, f"{where} {key}"
        np.testing.assert_array_equal(got[key], w, err_msg=f"{where} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_jax_trainer_s(tmp_path, data, case):
    from scrabblegan_tpu.train.loop import Trainer

    overrides = {**BASE, **CASES[case]}
    cfg = load_config(None, overrides)
    ref = Trainer(cfg, workdir=str(tmp_path / "jax"), verbose=False)
    ref.load_data(**data)
    port = Batches(port_load_config(None, overrides))
    port.load(**data)
    for name in ("seed_style", "seed_labels", "seed_z"):
        w = getattr(ref, name)
        g = getattr(port, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    for i in range(10):
        assert_same_batch(port.assemble(), ref._assemble(), f"{case} batch {i}")
    assert_same_batch(port.assemble(), ref.next_batch(), f"{case} next_batch")
    # the standing statistics' pinned draw, then the stream goes on alike
    pin = int(ref.seed_labels.shape[1])
    assert_same_batch(port.assemble(pin, pin), ref._assemble(bucket=pin, fake_bucket=pin),
                      f"{case} pinned")
    assert_same_batch(port.assemble(), ref._assemble(), f"{case} after the pin")


def test_batches_refuse_what_jax_refuses():
    cfg = port_load_config(None, {"parallel.batch_mix": "sample"})
    with pytest.raises(ValueError, match="padded"):
        Batches(cfg)
    with pytest.raises(ValueError, match="batch_mix"):
        Batches(dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, batch_mix="bogus")))


def rows(seed: int, n: int) -> list[dict]:
    """Step metric rows as the Trainers fetch them: float32 scalars."""
    rng = np.random.default_rng(seed)
    block = rng.normal(0, 3, (n, len(METRIC_NAMES))).astype(np.float32)
    block[1, 2] = np.float32(1e-8)
    return [dict(zip(METRIC_NAMES, vec)) for vec in block]


def test_summary_files_are_byte_identical(tmp_path):
    for name, writer_cls in (("jax", JaxSummaryWriter), ("port", SummaryWriter)):
        out = str(tmp_path / name)
        w = writer_cls(out)
        for e in range(2):
            for b, row in enumerate(rows(e, 3)):
                w.write_batch(e, b, row)
            w.end_epoch()
        w.close()
        w = writer_cls(out, append=True)  # a resumed run
        for b, row in enumerate(rows(9, 2)):
            w.write_batch(2, b, row)
        w.end_epoch()
        w.close()
    for fn in ("batch_summary.txt", "epoch_summary.txt", "batch_summary.csv"):
        got = (tmp_path / "port" / fn).read_bytes()
        assert got == (tmp_path / "jax" / fn).read_bytes(), fn
    lines = (tmp_path / "port" / "batch_summary.txt").read_text().splitlines()
    assert len(lines) == 1 + 8 and lines[0].count(";") == 15
