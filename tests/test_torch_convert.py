"""Carrying a fitted forest and a knowledge base from the reference."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.core.knowledge import KnowledgeBase as RKB
from repro.core.surrogate import make_forest as r_make_forest
from repro.sparksim import TaskSpec as RTaskSpec, generate_history as r_generate_history
from repro_torch.convert import knowledge_base_from_json, packed_forest_from_numpy
from repro_torch.core import KnowledgeBase


def _ref_forest(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((50, 6))
    y = X[:, 0] - 2 * X[:, 3] + 0.1 * rng.standard_normal(50)
    return r_make_forest(seed=seed).fit(X, y)


@pytest.mark.parametrize("as_dict", [False, True])
def test_packed_forest_from_numpy_predicts_like_reference(as_dict):
    pf = _ref_forest(1).pack()
    src = {k: getattr(pf, k) for k in ("feat", "thr", "child", "mean", "var", "roots",
                                        "depth", "y_mean", "y_std")} if as_dict else pf
    port = packed_forest_from_numpy(src, device="cpu")
    assert port.device == torch.device("cpu") and port.n_trees == pf.n_trees
    Xq = np.random.default_rng(2).random((77, 6))
    rm, rv = pf.predict(Xq)
    pm, pv = port.predict(torch.from_numpy(Xq))
    np.testing.assert_array_equal(pm.numpy(), rm)
    np.testing.assert_array_equal(pv.numpy(), rv)


@pytest.fixture(scope="module")
def ref_kb_record():
    return r_generate_history(RTaskSpec("tpch", 100, "C").workload(), n_obs=10, n_init=4, seed=5)


def _sig(kb):
    return {tid: [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())),
                   o.per_query_perf) for o in rec.observations]
            for tid, rec in kb.tasks.items()}


def test_knowledge_base_from_json_dict_file_and_dir(tmp_path, ref_kb_record):
    rkb = RKB(str(tmp_path / "kb"))
    rkb.add_task(ref_kb_record, persist=True)
    want = _sig(rkb)
    d = ref_kb_record.to_json()
    for src in (d, {d["task_id"]: d}, str(tmp_path / "kb"),
                str(tmp_path / "kb" / f"{d['task_id']}.json")):
        kb = knowledge_base_from_json(src)
        assert isinstance(kb, KnowledgeBase) and kb.root is None
        assert _sig(kb) == want


def test_port_kb_json_reads_back_in_reference(tmp_path, ref_kb_record):
    kb = knowledge_base_from_json(json.loads(json.dumps(ref_kb_record.to_json())))
    out = tmp_path / "port_kb"
    port_disk = KnowledgeBase(str(out))
    for rec in kb.tasks.values():
        port_disk.add_task(rec, persist=True)
    assert _sig(RKB(str(out))) == _sig(kb)
