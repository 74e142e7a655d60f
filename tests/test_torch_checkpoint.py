"""The port's checkpoints (oversim_tpu_torch/checkpoint.py).

Kademlia + KBRTest at 12 target slots under lifetime churn
(``init_deviation = jitter = 0``, as every file that compares leaves
with the JAX package): a restored run continues bit-identically; the
manifest fills itself in; a write that fails half-way leaves the
previous checkpoint whole; a directory that refuses fsync is tolerated;
another structure or another config hash is refused; a campaign's rows
are stored stacked ``[S, ...]``; and the file holds the same ``{path:
array}`` as the JAX package's checkpoint of the same state (its
``load_raw`` leaves under ``tree_flatten_with_path``), while a JAX file
given to the port is refused.  The JAX side runs in a fresh interpreter
(test_torch_engine.py ``fresh_jax_call`` says why).
"""

import dataclasses
import os
import stat

import numpy as np
import pytest
import torch

from oversim_tpu_torch import checkpoint as ckpt
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop, tree
from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
from oversim_tpu_torch.campaign import Campaign, CampaignParams
from oversim_tpu_torch.common.lookup import LookupConfig
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.kademlia import KademliaLogic
from oversim_tpu_torch.service import (ServiceLoop, ServiceParams,
                                       campaign_summarize_leaves)
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

CP = dict(model="lifetime", target_num=6, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
TICKS = 40


def port_sim(target=6):
    logic = KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=0.5)),
                          lcfg=LookupConfig(slots=4, merge=True))
    return tsim.Simulation(logic, tchurn.ChurnParams(**dict(CP, target_num=
                                                           target)),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**EP), device="cpu")


def jax_checkpoint(path):
    """The JAX package's checkpoint of its state after TICKS ticks,
    written to ``path``, read back as ``{keystr path: leaf}`` through its
    ``load_raw`` and the example's ``tree_flatten_with_path``."""
    import jax

    from oversim_tpu import checkpoint as jckpt
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps.kbrtest import KbrTestApp as JApp
    from oversim_tpu.apps.kbrtest import KbrTestParams as JParams
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.underlay import simple as jul
    logic = JKademlia(app=JApp(JParams(test_interval=0.5)),
                      lcfg=jlk.LookupConfig(slots=4, merge=True))
    sim = jsim.Simulation(logic, jchurn.ChurnParams(**CP),
                          jul.UnderlayParams(jitter=0.0),
                          jsim.EngineParams(**EP))
    st = sim.run_chunk(own(sim.init(seed=3)), TICKS)
    jckpt.save(path, st)
    leaves, _ = jckpt.load_raw(path)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(sim.init(seed=0))[0]]
    assert len(paths) == len(leaves)
    return dict(zip(paths, leaves))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "jax.npz")
    return path, JaxCall("test_torch_checkpoint", "jax_checkpoint", path=path)


def leaves_equal(a, b):
    fa, fb = interop.state_to_numpy(a), interop.state_to_numpy(b)
    assert sorted(fa) == sorted(fb)
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype
           or not np.array_equal(fa[k], fb[k])]
    assert not bad, bad


def test_roundtrip_and_exact_resume(tmp_path):
    sim = port_sim()
    st = sim.run_chunk(sim.init(3), TICKS)
    path = str(tmp_path / "ck.npz")
    nbytes = ckpt.save(path, st)
    assert nbytes == os.path.getsize(path) and not os.path.exists(
        path + ".tmp")
    a = sim.run_chunk(st, 30)
    b = sim.run_chunk(ckpt.load(path, sim.init(0)), 30)
    leaves_equal(a, b)
    assert int(a.tick) == TICKS + 30 and int(a.stats["c:kbr_sent"]) > 0


def test_manifest_fills_tick_t_now_git_rev_and_config_hash(tmp_path):
    """``save`` reads tick and t_now off the state and fills the git rev
    (None outside a git tree); the service loop adds the config hash,
    its window bookkeeping and a campaign's identity."""
    sim = port_sim()
    st = sim.run_chunk(sim.init(3), 5)
    path = str(tmp_path / "m.npz")
    ckpt.save(path, st, meta={"note": "x"})
    meta = ckpt.read_meta(path)
    assert meta["format"] == ckpt.FORMAT and meta["note"] == "x"
    assert meta["tick"] == 5 and meta["t_now"] == int(st.t_now)
    assert "git_rev" in meta

    camp = Campaign(sim, CampaignParams(replicas=2, base_seed=7))
    cfg = {"overlay": "kademlia", "n": 6}
    loop = ServiceLoop(camp, camp.init(), ServiceParams(
        window_sim_s=0.5, chunk=5, checkpoint_every=1, checkpoint_path=path),
        config=cfg, summarize=campaign_summarize_leaves)
    loop.run(n_windows=1)
    meta = ckpt.read_meta(path)
    assert meta["config_hash"] == loop.config_hash and len(
        loop.config_hash) == 16
    assert meta["campaign"] == camp.describe()
    assert meta["service"]["windows_done"] == 1
    assert len(meta["tick"]) == 2 and len(meta["t_now"]) == 2


def test_failed_write_leaves_previous_checkpoint_whole(tmp_path,
                                                       monkeypatch):
    sim = port_sim()
    st = sim.run_chunk(sim.init(3), 10)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, st, meta={"gen": 1})

    def half_write(f, arrays):
        f.write(b"PK\x03\x04 torn")
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt, "_write_npz", half_write)
    with pytest.raises(OSError):
        ckpt.save(path, sim.run_chunk(st, 5), meta={"gen": 2})
    monkeypatch.undo()
    assert ckpt.read_meta(path)["gen"] == 1
    leaves_equal(ckpt.load(path, sim.init(0)), st)


def test_directory_fsync_refusal_is_tolerated(tmp_path, monkeypatch):
    real_fsync = os.fsync
    dirs = []

    def picky_fsync(fd):
        if stat.S_ISDIR(os.fstat(fd).st_mode):
            dirs.append(fd)
            raise OSError(22, "Invalid argument")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", picky_fsync)
    sim = port_sim()
    st = sim.init(3)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, st)
    assert dirs and not os.path.exists(path + ".tmp")
    leaves_equal(ckpt.load(path, sim.init(0)), st)


def test_structure_and_config_mismatch_refused(tmp_path):
    sim = port_sim()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, sim.init(3), meta={"config_hash": "abc123"})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load(path, port_sim(target=8).init(0))
    with pytest.raises(ValueError, match="scenario mismatch"):
        ckpt.load(path, sim.init(0), expect_config="zzz999")
    ckpt.load(path, sim.init(0), expect_config="abc123")


def test_campaign_rows_stored_stacked(tmp_path):
    camp = Campaign(port_sim(), CampaignParams(replicas=2, base_seed=7))
    cs = camp.run_chunk(camp.init(), 20)
    path = str(tmp_path / "camp.npz")
    ckpt.save(path, cs)
    flat, meta = ckpt.load_raw(path)
    want = interop.state_to_numpy(tree.stack(cs))
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert flat[k].shape[0] == 2 and flat[k].dtype == v.dtype, k
        assert np.array_equal(flat[k], v), k
    assert meta["tick"] == [20, 20]
    rows = ckpt.load(path, camp.init())
    assert isinstance(rows, list) and len(rows) == 2
    for a, b in zip(rows, cs):
        leaves_equal(a, b)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load(path, Campaign(camp.sim, CampaignParams(replicas=3))
                  .init())


def test_same_arrays_as_the_jax_checkpoint(tmp_path, jax_ref):
    """The JAX checkpoint of a state, read through ``load_raw``, and the
    port's checkpoint of that state carried over by ``interop`` hold the
    same arrays under the same paths and dtypes; the port's own run to
    the same tick writes the same file content; a JAX file is refused."""
    jax_path, call = jax_ref
    want = call.result()
    sim = port_sim()
    carried = interop.state_from_numpy(want, sim)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, carried)
    got, _ = ckpt.load_raw(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    ckpt.save(path, sim.run_chunk(sim.init(3), TICKS))
    own_run, _ = ckpt.load_raw(path)
    bad = [k for k in want if not np.array_equal(own_run[k], want[k])]
    assert not bad, bad
    with pytest.raises(ValueError, match="JAX-package checkpoint"):
        ckpt.load(jax_path, sim.init(0))
    with pytest.raises(ValueError, match="JAX-package checkpoint"):
        ckpt.read_meta(jax_path)


def test_state_copies_are_real():
    """The loop's snapshot copies never alias the state they copy."""
    from oversim_tpu_torch.service.loop import _default_copy
    sim = port_sim()
    st = sim.init(3)
    snap = _default_copy(st)
    for (_, a), (_, b) in zip(tree.leaves_with_path(st),
                              tree.leaves_with_path(snap)):
        assert a.data_ptr() != b.data_ptr() or a.numel() == 0
    st.pool.valid.fill_(True)
    assert not bool(snap.pool.valid.any())
    assert dataclasses.is_dataclass(snap)
