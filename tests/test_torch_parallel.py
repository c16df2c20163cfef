#!/usr/bin/env python
"""PyTorch port, the last of aps_tpu: the tensor-parallel layout against
aps_tpu's tp_param_shardings, the inference commands' IO pipeline
(aps_tpu_torch/eval/pipeline.py) against aps_tpu's and against the serial
loop, and EendTask against aps_tpu's. The two-rank runs of tensor and
sequence parallelism live in tests/test_torch_distributed.py, whose ranks
they share.

    python -m pytest tests/test_torch_parallel.py -q
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu_torch.eval.pipeline import (AsyncWriter,  # noqa: E402
                                         prefetch_iter)

# EendTask in float64 against aps_tpu's under jax's x64
EEND_ATOL = 1e-6


def width_256_flagship(vocab: int):
    """The flagship at its full width with 2 encoder and 2 decoder layers
    (init only)."""
    from aps_tpu_torch.flagship import build_flagship, flagship_conf
    conf = flagship_conf(vocab, small=False)
    conf["nnet_conf"]["enc_kwargs"]["num_layers"] = 2
    conf["nnet_conf"]["dec_kwargs"]["num_layers"] = 2
    torch.manual_seed(0)
    return build_flagship(conf)


def _paths(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _paths(val, path)
        else:
            yield path, val


@pytest.mark.parametrize("vocab", [64, 300])
def test_tp_layout_is_aps_tpus(vocab):
    """The port's tp_param_shardings picks, leaf for leaf after the
    converter's names, the leaves that aps_tpu's tp_param_shardings shards
    on a mesh with a model axis of 2: every attention, feed-forward and
    conv-module projection and the subsampling's output layer; at a vocab
    of 300 also the CTC head (300 x 256) and the decoder's embedding's
    256 columns, not its output layer (299 rows, odd); never a bias, a
    norm, a convolution kernel or the 257 x 64 pose table."""
    import jax

    from aps_tpu.parallel import build_mesh
    from aps_tpu.parallel import tp_param_shardings as jax_shardings
    from aps_tpu_torch.convert import _leaves, to_variables
    from aps_tpu_torch.parallel import tp_param_shardings
    model = width_256_flagship(vocab)
    mine = tp_param_shardings(model, 2)
    leaves = _leaves(model)
    got = {leaves[name][1] for name in mine}
    params = to_variables(model)["params"]
    specs = jax_shardings(build_mesh(jax.devices()[:8], model=2), params)
    want = {path for path, spec in _paths(
        jax.tree_util.tree_map(lambda s: s.spec, specs,
                               is_leaf=lambda s: hasattr(s, "spec")))
            if "model" in tuple(spec)}
    assert got == want
    assert len(want) == (31 if vocab == 300 else 29)
    axes = {leaves[name][1]: axis for name, axis in mine.items()}
    if vocab == 300:
        assert axes["decoder/vocab_embed/embedding"] == 1
        assert axes["ctc_head/kernel"] == 0
    assert not any(p.endswith("bias") or "pose" in p for p in got)
    assert tp_param_shardings(model, 1) == {}


def test_tp_layout_keeps_recurrent_conv_and_tied_weights_replicated():
    """The port's rule beside aps_tpu's on what aps_tpu would shard but
    the port keeps whole: a cuDNN LSTM's weights (aps_tpu's cells are
    Dense kernels) and a weight tied between an embedding and an output
    layer; a convolution kernel is replicated in both."""
    from torch import nn

    from aps_tpu_torch.parallel import tp_param_shardings

    class Toy(nn.Module):

        def __init__(self):
            super(Toy, self).__init__()
            self.proj = nn.Linear(256, 512)
            self.small = nn.Linear(256, 128)
            self.odd = nn.Linear(256, 257)
            self.rnn = nn.LSTM(256, 256)
            self.conv = nn.Conv1d(256, 256, 1)
            self.embed = nn.Embedding(300, 256)
            self.out = nn.Linear(256, 300, bias=False)
            self.out.weight = self.embed.weight

    assert tp_param_shardings(Toy(), 2) == {"proj.weight": 0}
    assert tp_param_shardings(Toy(), 4, min_dim=128) == {
        "proj.weight": 0, "small.weight": 0}


def test_column_parallel_layers_in_one_process():
    """The column-parallel layers at a model size of 1 (the whole weight
    on one rank, a group of one) give nn.Linear's and nn.Embedding's
    outputs and gradients; a fused projection's part through
    forward_rows is the product with its rows."""
    import torch.distributed as dist

    from aps_tpu_torch.parallel import tp
    if dist.is_initialized():
        pytest.skip("a process group is up already")
    dist.init_process_group("gloo", init_method="tcp://localhost:0",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(1)
        linear = torch.nn.Linear(8, 12).double()
        embed = torch.nn.Embedding(10, 6).double()
        x = torch.randn((3, 5, 8), generator=gen, dtype=torch.float64,
                        requires_grad=True)
        ids = torch.randint(0, 10, (3, 5), generator=gen)
        col = tp.ColumnParallelLinear(linear, 0, 1, dist.group.WORLD)
        emb = tp.ColumnParallelEmbedding(embed, 0, 1, dist.group.WORLD)
        for mine, plain, arg in ((col, linear, x), (emb, embed, ids)):
            got, want = mine(arg), plain(arg)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
            got.square().sum().backward()
            want.square().sum().backward()
            torch.testing.assert_close(mine.weight.grad, plain.weight.grad,
                                       rtol=0, atol=1e-12)
        part = col.forward_rows(x, 4, 8)
        torch.testing.assert_close(part, torch.nn.functional.linear(
            x, linear.weight[4:8], linear.bias[4:8]), rtol=0, atol=1e-12)
        assert tp.shard_of(col.weight) == tp.TpShard(0, 0, 12, 12,
                                                     dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# eval/pipeline.py
# ---------------------------------------------------------------------------
def test_prefetch_iter_yields_in_order_like_aps_tpus():
    from aps_tpu.eval.pipeline import prefetch_iter as jax_prefetch
    items = [(f"utt{i}", np.full(3, i)) for i in range(20)]
    got = list(prefetch_iter(iter(items), depth=3))
    want = list(jax_prefetch(iter(items), depth=3))
    assert [k for k, _ in got] == [k for k, _ in want] == \
        [k for k, _ in items]


def test_prefetch_iter_reraises_the_readers_error():
    def reader():
        yield 1
        yield 2
        raise OSError("bad wav")

    seen = []
    with pytest.raises(OSError, match="bad wav"):
        for item in prefetch_iter(reader(), depth=1):
            seen.append(item)
    assert seen == [1, 2]


def test_prefetch_iter_stops_an_abandoned_producer():
    """A consumer that leaves the loop early: the producer, blocked on its
    full queue, stops instead of reading on."""
    produced = []
    gone = threading.Event()

    def reader():
        try:
            for i in range(1000):
                produced.append(i)
                yield i
        finally:
            gone.set()

    for item in prefetch_iter(reader(), depth=2):
        if item == 3:
            break
    assert gone.wait(timeout=5.0)
    assert len(produced) <= 8
    # an exception in the consuming loop stops it the same way
    gone.clear()
    with pytest.raises(KeyError):
        for item in prefetch_iter(reader(), depth=2):
            raise KeyError(item)
    assert gone.wait(timeout=5.0)


def test_async_writer_reraises_and_finishes_every_job(tmp_path):
    def write(name, delay):
        time.sleep(delay)
        (tmp_path / name).write_text(name)

    with AsyncWriter(workers=2) as writer:
        for i in range(6):
            writer.submit(write, f"f{i}", 0.01 * (6 - i))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"f{i}" for i in range(6)]

    def fail():
        raise ValueError("disk full")

    writer = AsyncWriter(workers=2)
    writer.submit(write, "g", 0.0)
    writer.submit(fail)
    with pytest.raises(ValueError, match="disk full"):
        writer.close()
    assert (tmp_path / "g").read_text() == "g"
    # an error in the caller's loop is not masked by the pool
    with pytest.raises(RuntimeError, match="caller"):
        with AsyncWriter(workers=1) as writer:
            writer.submit(fail)
            raise RuntimeError("caller")


class _SerialWriter(object):
    """AsyncWriter's interface, each job run at once (the serial loop)."""

    def __init__(self, workers: int = 4):
        pass

    def submit(self, fn, *args, **kwargs):
        fn(*args, **kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _tree_bytes(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_separate_writes_the_serial_loops_bytes(tmp_path, monkeypatch):
    """`separate` with the prefetch and the writer pool writes the files
    of the serial loop byte for byte (the wavs and the scp lines in the
    order read), batched and utterance by utterance; the scps list the
    utterances in the corpus' order."""
    import json
    import pickle

    from test_torch_sse import NNET_CONF, _write_corpus

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.libs import aps_sse_nnet
    _write_corpus(tmp_path, num_utts=7)
    cpt = tmp_path / "cpt"
    cpt.mkdir()
    torch.manual_seed(4)
    variables = to_variables(aps_sse_nnet("sse@time_tcn")(**NNET_CONF))
    (cpt / "train.yaml").write_text(json.dumps(dict(
        nnet="sse@time_tcn", nnet_conf=NNET_CONF, task="sse@sisnr",
        task_conf={}, data_conf={}, trainer_conf={})))
    (cpt / "best.ckpt").write_bytes(pickle.dumps({
        "params": {"nnet": variables["params"]},
        "mstate": {"batch_stats": {"nnet": variables["batch_stats"]}},
        "epoch": 1}))
    for extra in ([], ["--batch-size", "3"]):
        outs = {}
        for how in ("pipelined", "serial"):
            if how == "serial":
                monkeypatch.setattr(separate, "prefetch_iter",
                                    lambda it, depth: it)
                monkeypatch.setattr(separate, "AsyncWriter", _SerialWriter)
            sep_dir = tmp_path / f"{how}{len(extra)}"
            stats = separate.main([
                str(tmp_path / "mix.scp"), str(sep_dir), "--checkpoint",
                str(cpt), "--sr", "8000", "--device", "cpu"] + extra)
            assert stats["utts"] == 7
            # the scp lines name the directory
            outs[how] = {k: v.replace(str(sep_dir).encode(), b"DIR")
                         for k, v in _tree_bytes(sep_dir).items()}
            monkeypatch.undo()
        assert outs["pipelined"] == outs["serial"]
        assert len(outs["serial"]) == 2 * 7 + 2
        keys = [line.split()[0] for line in outs["serial"][
            "spk1.scp"].decode().splitlines()]
        assert keys == [f"utt{n}" for n in range(7)]


# ---------------------------------------------------------------------------
# task/eend.py
# ---------------------------------------------------------------------------
def test_eend_task_matches_aps_tpus():
    """EendTask's objf and its permutation-invariant loss over two
    speaker streams, against aps_tpu's on the same logits and labels in
    float64 (jax under x64)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from aps_tpu.task.eend import EendTask as JaxEend
    from aps_tpu_torch.task.eend import EendTask

    class Split(torch.nn.Module):
        """The mixture's two rows as the model's two output streams."""

        def forward(self, mix):
            return [mix[:, 0], mix[:, 1]]

    class JaxSplit(fnn.Module):

        def __call__(self, mix, training=True):
            return [mix[:, 0], mix[:, 1]]

    rng = np.random.default_rng(9)
    logits = 3 * rng.standard_normal((4, 2, 50))
    labels = [(rng.random((4, 50)) > 0.5).astype(np.float64)
              for _ in range(2)]
    # the second utterance's speakers swapped: the permutation matters
    labels[0][1], labels[1][1] = labels[1][1].copy(), labels[0][1].copy()
    mine = EendTask(Split(), num_spks=2)
    got_objf = mine.objf(torch.from_numpy(logits[:, 0]),
                         torch.from_numpy(labels[0]))
    got = mine({"mix": torch.from_numpy(logits),
                "ref": [torch.from_numpy(r) for r in labels]})["loss"]
    with jax.enable_x64(True):
        theirs = JaxEend(nnet=JaxSplit(), num_spks=2)
        want_objf = theirs.objf(jnp.asarray(logits[:, 0]),
                                jnp.asarray(labels[0]))
        want = theirs.apply({}, {"mix": jnp.asarray(logits),
                                 "ref": [jnp.asarray(r) for r in labels]},
                            training=True)["loss"]
        want_objf, want = np.asarray(want_objf), np.asarray(want)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got_objf.numpy(), want_objf, rtol=0,
                               atol=EEND_ATOL)
    np.testing.assert_allclose(got.item(), float(want), rtol=0,
                               atol=EEND_ATOL)
    # the loss is the better permutation's: below the fixed one's
    fixed = (mine.objf(torch.from_numpy(logits[:, 0]),
                       torch.from_numpy(labels[0])) +
             mine.objf(torch.from_numpy(logits[:, 1]),
                       torch.from_numpy(labels[1]))).mean()
    assert got.item() < fixed.item()
