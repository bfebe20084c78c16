"""The port's async sharded checkpoint engine (`ray_tpu_torch.train.checkpoint`):
round trips of tensors (f32, bf16, int64), an Adam state_dict and
non-array leaves; the snapshot taken before `save_async` returns; digest
checks; retention, `latest_checkpoint` and pins; and checkpoints that
cross between the packages both ways on the reference's on-disk format.

Counterpart tests: tests/test_checkpoint.py (the host-array cases; the
resharding cases need a device mesh, which the port does not have yet).
No runtime starts here: the engine runs on the storage plane alone.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.train import checkpoint as jck
from ray_tpu_torch import storage
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.transformer import Transformer, TransformerConfig
from ray_tpu_torch.train import checkpoint as ck

REPO = pathlib.Path(__file__).resolve().parents[1]


def _adam_state():
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 4)
    opt = torch.optim.Adam(lin.parameters(), lr=1e-3)
    for _ in range(2):
        opt.zero_grad()
        lin(torch.randn(3, 6)).square().sum().backward()
        opt.step()
    return lin, opt


def _assert_tree_equal(a, b):
    """Equal trees; a state_dict's OrderedDict comes back a dict, as in
    the reference's walk."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        assert a == b


def test_roundtrip_tensors_adam_and_plain_leaves(tmp_path):
    lin, opt = _adam_state()
    state = {"f32": torch.randn(5, 3),
             "bf16": torch.randn(17).to(torch.bfloat16),
             "i64": torch.arange(-4, 9, dtype=torch.int64),
             "model": lin.state_dict(), "optim": opt.state_dict(),
             "meta": [1, "two", 3.0, None, (4, 5)]}
    d = str(tmp_path / "ck")
    info = ck.save_async(state, d, step=3).result(30)
    assert info["kind"] == "state" and info["step"] == 3
    got = ck.restore(d, device="cpu")
    _assert_tree_equal(got, state)
    # int keys of the optimizer state survive, and step stays 0-d
    assert list(got["optim"]["state"]) == [0, 1]
    assert got["optim"]["state"][0]["step"].shape == ()
    opt2 = torch.optim.Adam(lin.parameters(), lr=1e-3)
    opt2.load_state_dict(got["optim"])
    _assert_tree_equal(opt2.state_dict(), opt.state_dict())
    # device=None: numpy leaves, bf16 (which numpy lacks) a CPU tensor
    host = ck.restore(d)
    assert isinstance(host["f32"], np.ndarray)
    assert np.array_equal(host["i64"], state["i64"].numpy())
    assert host["bf16"].dtype == torch.bfloat16
    assert torch.equal(host["bf16"], state["bf16"])
    man = ck.load_manifest(d)
    by_path = {leaf["path"]: leaf for leaf in man["leaves"]}
    assert by_path["bf16"]["dtype"] == "bfloat16"
    assert by_path["f32"]["sharding"] == "host"


def test_save_async_snapshots_before_it_returns(tmp_path):
    """Adam's next in-place step must not reach a save still being
    written: change every tensor right after save_async returns."""
    lin, opt = _adam_state()
    state = {"model": lin.state_dict(), "optim": opt.state_dict(),
             "bf16": torch.ones(8, dtype=torch.bfloat16)}
    want = {"model": {k: v.clone() for k, v in state["model"].items()},
            "optim": {i: {k: v.clone() for k, v in s.items()}
                      for i, s in state["optim"]["state"].items()}}
    d = str(tmp_path / "ck")
    handle = ck.save_async(state, d, step=1)
    with torch.no_grad():
        for t in state["model"].values():
            t.add_(1.0)
        for s in state["optim"]["state"].values():
            for t in s.values():
                t.add_(1.0)
        state["bf16"].add_(1.0)
    handle.result(30)
    got = ck.restore(d, device="cpu")
    _assert_tree_equal(got["model"], want["model"])
    _assert_tree_equal(got["optim"]["state"], want["optim"])
    assert torch.equal(got["bf16"], torch.ones(8, dtype=torch.bfloat16))


def test_restore_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    ck.save({"w": torch.arange(16.0)}, d, step=1)
    victim = ck.load_manifest(d)["leaves"][0]["shards"][0]["file"]
    blob = bytearray(storage.get_bytes(storage.join(d, victim)))
    blob[-1] ^= 0xFF
    storage.put(storage.join(d, victim), bytes(blob))
    with pytest.raises(storage.StorageError, match="digest"):
        ck.restore(d)
    ck.restore(d, verify=False)


def test_retention_keeps_last_k_and_pins(tmp_path):
    parent = str(tmp_path / "cks")
    dirs = [storage.join(parent, f"checkpoint_{i:06d}") for i in range(5)]
    for i, d in enumerate(dirs):
        ck.save({"w": torch.full((4,), float(i))}, d, step=i)
    assert ck.latest_checkpoint(parent) == dirs[-1]
    ck.pin(dirs[0], owner="trial-clone")
    assert set(ck.retention(parent, keep=2)) == {dirs[1], dirs[2]}
    rows = ck.list_checkpoints(parent)
    assert [r["uri"] for r in rows] == [dirs[0], dirs[3], dirs[4]]
    assert rows[0]["pins"] == ["trial-clone"]
    assert torch.equal(ck.restore(dirs[0], device="cpu")["w"], torch.zeros(4))
    ck.unpin(dirs[0], owner="trial-clone")
    assert ck.retention(parent, keep=2) == [dirs[0]]


def test_latest_checkpoint_orders_by_commit_time(tmp_path):
    parent = str(tmp_path / "cks")
    pre = storage.join(parent, "checkpoint_r0_000003")
    post = storage.join(parent, "checkpoint_r1_000001")
    ck.save({"w": torch.full((2,), 3.0)}, pre, step=3)
    ck.save({"w": torch.full((2,), 1.0)}, post, step=1)
    assert ck.latest_checkpoint(parent) == post
    assert ck.retention(parent, keep=1) == [pre]


def test_same_inputs_write_the_reference_bytes(tmp_path):
    """Shard files, the tree file and their digests equal the JAX
    package's for the same host inputs (tensors on the port's side)."""
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    i = np.arange(-3, 4, dtype=np.int64)
    meta = [1, "two", None]
    m_ref = jck.save({"w": w, "i": i, "meta": meta}, str(tmp_path / "j"))
    m_port = ck.save({"w": torch.from_numpy(w.copy()),
                      "i": torch.from_numpy(i.copy()), "meta": meta},
                     str(tmp_path / "t"))

    def files(m):
        return [(s["file"], s["sha1"], s["bytes"])
                for leaf in m["leaves"] for s in leaf["shards"]]

    assert files(m_port) == files(m_ref)
    assert m_port["tree_sha1"] == m_ref["tree_sha1"]
    assert [leaf["dtype"] for leaf in m_port["leaves"]] == ["float32", "int64"]


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    lin, opt = _adam_state()
    state = {"model": lin.state_dict(), "optim": opt.state_dict(),
             "i64": torch.arange(5), "step": 7}
    d = str(tmp_path / "ck")
    ck.save(state, d, step=7)
    got = jck.restore(d)
    assert got["step"] == 7
    for k, v in state["model"].items():
        assert isinstance(got["model"][k], np.ndarray)
        assert np.array_equal(got["model"][k], v.numpy())
    for i, s in state["optim"]["state"].items():
        for k, v in s.items():
            assert np.array_equal(got["optim"]["state"][i][k], v.numpy())
    assert np.array_equal(got["i64"], np.arange(5))
    assert got["optim"]["param_groups"] == state["optim"]["param_groups"]


def test_jax_checkpoint_of_flax_params_gives_the_same_logits(tmp_path):
    shape = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=4, d_ff=160, max_seq=32)
    jmodel = JaxTransformer(JaxConfig(**shape, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    d = str(tmp_path / "flax")
    jck.save(params, d, step=1)
    tree = ck.restore(d)
    model = Transformer(TransformerConfig(**shape, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(params_from_flax(tree))
    toks = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_jax_bf16_leaf_needs_ml_dtypes(tmp_path, monkeypatch):
    """A bf16 leaf that the JAX package wrote is an ml_dtypes array in its
    shard file: it restores exactly where ml_dtypes imports, and raises
    naming the leaf where it does not."""
    x = jnp.asarray(np.linspace(-3, 3, 40, dtype=np.float32)).astype(
        jnp.bfloat16)
    d = str(tmp_path / "bf")
    jck.save({"layer": {"w": x}}, d, step=1)
    got = ck.restore(d, device="cpu")["layer"]["w"]
    want = torch.from_numpy(np.asarray(x).view(np.uint16).astype(np.int32))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16).to(torch.int32) & 0xFFFF, want)
    for name in [m for m in sys.modules
                 if m == "ml_dtypes" or m.startswith("ml_dtypes.")]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ModuleNotFoundError, match="layer/w"):
        ck.restore(d)


_PORT_ONLY = """
import sys, tempfile, torch
from ray_tpu_torch.train import checkpoint as ck
d = tempfile.mkdtemp()
ck.save({"w": torch.arange(6.0), "opt": {0: {"step": torch.tensor(2.0)}}}, d)
got = ck.restore(d, device="cpu")
assert torch.equal(got["w"], torch.arange(6.0))
assert got["opt"][0]["step"].shape == ()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax"))
assert not bad, bad
print("ok")
"""


def test_port_reads_its_format_without_the_jax_package():
    """The tree file names the format's stub global; reading it back
    imports nothing of the JAX package."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _PORT_ONLY], env=env,
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
