"""Each traffic generator is a function of the seed: the same seed gives the
same inputs, another seed other inputs."""

import hashlib

import numpy as np
import torch

from perfbench import common, datagen, weights
from perfbench.drivers import offline_batches, requests


def _digest(root) -> str:
    h = hashlib.sha256()
    for path in sorted(root.rglob("*")):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def test_train_data_set(tmp_path):
    tr = common.traffic_file("train.b16")
    rows = common.find_cell(common.manifest(), "train.recommended.b16")[2]["dataset_rows"]
    args = (rows // 10, tr["length_weights"], 3, tr["noise_sd"])
    digests = [_digest(tmp_path / name) for name, seed in (("a", 1), ("b", 1), ("c", 2))
               if datagen.write_dataset(str(tmp_path / name), seed, *args)]
    assert digests[0] == digests[1] != digests[2]
    counts = [len(list((tmp_path / "a" / "words-Reading" / str(n)).glob("*.png")))
              for n in range(1, 11)]
    assert sum(counts) >= rows // 10 and counts[2] == max(counts)


def test_offline_inputs():
    def draw(seed):
        d = offline_batches.Driver({"serving": {"offline_batches": {}}},
                                   {"batch": 4, "length": 3}, seed, "cpu")
        d.latent, d.classes = 128, 52
        d.inputs_gen = weights.seed_generator(seed + 2, "cpu")
        return [torch.cat([t.float().flatten() for t in d._inputs()]) for _ in range(2)]
    a, b, c = draw(5), draw(5), draw(2 ** 31 + 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])


def test_request_stream_keeps_the_work_and_changes_the_order():
    tr = common.traffic_file("request.b16")

    def stream(seed, n):
        d = requests.Driver({"serving": {"requests": {}}}, tr, seed, "cpu")
        d.classes, d._order = 52, []
        return [d._next_request() for _ in range(n)]
    cycle = sum(tr["length_cycle"])
    a, b, c = stream(7, cycle), stream(7, cycle), stream(2 ** 31 + 7, cycle)
    assert [(w.tolist(), p) for w, p in a] == [(w.tolist(), p) for w, p in b]
    assert [w.tolist() for w, _ in a] != [w.tolist() for w, _ in c]
    lengths = lambda s: sorted(len(w) for w, _ in s)  # noqa: E731
    assert lengths(a) == lengths(c) == sorted(np.repeat(np.arange(1, 11), tr["length_cycle"]))


def test_style_pages_and_weights():
    assert np.array_equal(datagen.style_pages(3, 4), datagen.style_pages(3, 4))
    assert not np.array_equal(datagen.style_pages(3, 4), datagen.style_pages(4, 4))
    leaves = {"g": [("a.weight", (8, 4, 3, 3)), ("a.u", (1, 8)), ("a.sigma", ()),
                    ("bn.weight", (8,)), ("bn.bias", (8,)), ("bn.running_mean", (8,)),
                    ("bn.running_var", (8,))]}
    one, two, other = (weights.make(leaves, s, "cpu")["g"] for s in (9, 9, 2 ** 31 + 9))
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert float(one["a.sigma"]) > 0 and torch.equal(one["bn.running_var"], torch.ones(8))
