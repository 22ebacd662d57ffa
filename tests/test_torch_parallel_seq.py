"""The port's sharded steps on a gloo ``(1, 4)`` host mesh (CPU): four
ranks on the ``model`` axis, where smoke ``llama3.2-1b``'s 2 KV heads do
not divide the axis, so the attention keeps every head on every rank
(GQA's replicated KV heads) and the decode cache shards its sequence
instead (``param_pspecs``' second pass) -- written in place rank by rank
(``parallel.sharding.write_rows``) and gathered whole before the
attention.  The checks and limits are ``test_torch_parallel.py``'s at
``(2, 2)``; ``tests/torch_parallel_worker.py`` records the readings.
"""

import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker as W  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    check_ckpt,
    check_serve,
    check_train,
    check_wrong_shard,
)


@pytest.fixture(scope="module")
def mesh14(tmp_path_factory):
    out = W.launch(1, 4, tmp_path_factory.mktemp("gloo_1x4"))
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", [f[0] for f in W.FAMILIES])
def test_train_step_matches_unsharded_1x4(mesh14, name):
    check_train(mesh14, name)


def test_wrong_shard_reads_above_limits_1x4(mesh14):
    check_wrong_shard(mesh14)


@pytest.mark.parametrize("mode", ["serial", "vmap"])
def test_serving_tokens_1x4(mesh14, mode):
    check_serve(mesh14, mode)


def test_cache_sequence_sharded_1x4(mesh14):
    # (L, B, S, KV, hd): 2 KV heads do not divide 4, the sequence takes it
    assert mesh14["serve"]["cache_specs"][0] == ["None", "data", "model"]


def test_checkpoint_round_trip_1x4(mesh14):
    check_ckpt(mesh14)
