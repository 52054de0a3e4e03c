"""The port's baselines (``diffsg_tpu_torch/baselines``: ``gd``, ``mtfnn``,
``ppo``, ``gekko_oracle``), its torch-checkpoint readers and ``write_csv``
against the JAX package's, on the CPU, on numpy-seeded inputs and CSVs that
the port's ``make_rows`` writes (the JAX package's bytes).

Tolerances: GD within 1e-5 of each output's magnitude; the MLP and PPO
forwards on carried parameters within 1e-6; the shipped checkpoints'
predictions within 1e-5 of their magnitude; two training epochs on JAX's
own draws (replayed from its keys) within 1e-5 of the largest parameter's
magnitude (measured: 3.8e-7 to 1.1e-6), with the logged losses and rewards
at the log's precision.

GD on CO is held to the JAX function run op by op (``jax.disable_jit``):
its iteration grows a one-ulp difference into an O(1) change of the answer,
and XLA's compiled loop contracts ``y - step * g`` into fused multiply-adds,
which parts the JAX package's compiled answer from its own op-by-op answer
on about 30% of CO rows. The port, like the JAX function op by op, rounds
after every op, on the CPU and on the card.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffsg_tpu.baselines as jb
from diffsg_tpu.baselines import gekko_oracle as jax_gekko
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.base import objective_metrics as jax_objective_metrics
from diffsg_tpu.train import torch_style_init as jax_torch_style_init
from diffsg_tpu.utils.metrics import write_csv as jax_write_csv
import diffsg_tpu_torch.baselines as pb
from diffsg_tpu_torch.baselines import gekko_oracle
from diffsg_tpu_torch.data.datasets import make_rows, write_csv as write_rows
from diffsg_tpu_torch.tasks import TASKS, objective_metrics
from diffsg_tpu_torch.tools import fewstep, report, train_baselines
from diffsg_tpu_torch.utils import params_from_jax
from diffsg_tpu_torch.utils.metrics import write_csv

import tools.report as jax_report

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CO_CSV = REPO / "datasets" / "3nodes_50000samples_new.csv"
# The retrained checkpoints' metrics on the whole CO test split (15,000 rows),
# pinned by tests/test_baselines.py:362,365 within 2e-3.
CO_PINS = {"retrain_mtfnn_co": 1.06299, "retrain_ppo_co": 1.59212}


def _rel(a, b):
    """max |a - b| over the magnitude of ``a``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """{family: (port TaskData, JAX TaskData)} on small made CSVs (CO: the
    repository's CO set)."""
    root = tmp_path_factory.mktemp("baseline_data")
    msr = write_rows(root / "3c_10w_900samples.csv", make_rows("msr", samples=900))
    nu = write_rows(root / "3u_18mW_900samples.csv", make_rows("nu", samples=900, grid_step=8.0))
    out = {}
    for fam, task, path in (("co", "co", CO_CSV), ("msr", "msr", msr), ("nu", "nu", nu)):
        out[fam] = (TASKS[task].load(str(path)), JAX_TASKS[task].load(str(path)))
    return out


# -- GD ---------------------------------------------------------------------------------


@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_gd_matches_jax(splits, fam):
    data, jdata = splits[fam]
    rows = 512
    if fam == "nu":
        X = np.asarray(data.X_test[:rows], np.float32)      # normalized, as the reference
        got = pb.nu_gd_solve(torch.from_numpy(X), P_sum=data.config["P_sum"]).numpy()
        want = np.asarray(jb.nu_gd_solve(jnp.asarray(X), P_sum=data.config["P_sum"]))
    else:
        X = np.asarray(TASKS[fam].unnormalize_x(data.X_test[:rows], data.config), np.float32)
        if fam == "msr":
            got = pb.msr_gd_solve(torch.from_numpy(X), W=data.config["W"]).numpy()
            want = np.asarray(jb.msr_gd_solve(jnp.asarray(X), W=data.config["W"]))
        else:
            got = pb.co_gd_solve(torch.from_numpy(X), node_num=3).numpy()
            with jax.disable_jit():
                want = np.asarray(jb.co_gd_solve(jnp.asarray(X), node_num=3))
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(want, got) <= 1e-5


def test_gd_feasible(splits):
    """MSR rows sum to W, NU powers to P_sum; CO shares min-max to [0, 1]."""
    data, _ = splits["msr"]
    g = np.asarray(TASKS["msr"].unnormalize_x(data.X_test, data.config), np.float32)
    P = pb.msr_gd_solve(torch.from_numpy(g), W=10.0).numpy()
    np.testing.assert_allclose(P.sum(1), 10.0, rtol=1e-5)
    data, _ = splits["nu"]
    S = pb.nu_gd_solve(torch.from_numpy(np.asarray(data.X_test, np.float32)), P_sum=18.0).numpy()
    np.testing.assert_allclose(S[:, 2:].sum(1), 18.0, rtol=1e-5)
    data, _ = splits["co"]
    X = np.asarray(TASKS["co"].unnormalize_x(data.X_test[:512], data.config), np.float32)
    Y = pb.co_gd_solve(torch.from_numpy(X)).numpy()
    assert Y.min() == 0.0 and Y.max() == 1.0


# -- the MLP and PPO forwards -------------------------------------------------------------


@pytest.mark.parametrize("name", ["co", "msr", "nu", "none"])
def test_mlp_forward_matches_jax(name):
    """Every head on parameters carried from flax (``params_from_jax``)."""
    if name == "none":
        jm, pm = jb.MLP(features=(16, 8, 4)), pb.MLP(5, (16, 8, 4))
    else:
        jm = {"co": jb.mtfnn_co_model, "msr": jb.mtfnn_msr_model, "nu": jb.mtfnn_nu_model}[name]()
        pm = {"co": pb.mtfnn_co_model, "msr": pb.mtfnn_msr_model, "nu": pb.mtfnn_nu_model}[name]()
    in_dim = pm.lin1.kernel.shape[0]
    X = np.random.default_rng(0).uniform(0, 1, (64, in_dim)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, in_dim)))["params"]
    pm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(X)))
    with torch.no_grad():
        got = pm(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("state_dim,action_dim", [(9, 3), (3, 3), (6, 5)])
def test_ppo_forward_matches_jax(state_dim, action_dim):
    ja = jb.PPOAgent(state_dim, action_dim)
    params = jax.tree.map(np.asarray, jb.orthogonal_ppo_init(ja, jax.random.PRNGKey(2)))
    params["log_std"] = np.full((1, action_dim), -0.3, np.float32)
    pa = pb.PPOAgent(state_dim, action_dim)
    pa.load_state_dict(params_from_jax(params), strict=True)
    X = np.random.default_rng(1).uniform(0, 1, (64, state_dim)).astype(np.float32)
    want = ja.apply({"params": params}, jnp.asarray(X))
    with torch.no_grad():
        got = pa(torch.from_numpy(X))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_orthogonal_ppo_init_properties():
    """W W^T (or W^T W) = gain^2 I on each (out, in) weight, zero biases,
    log_std 0; the same generator seed draws the same init."""
    agent = pb.orthogonal_ppo_init(pb.PPOAgent(9, 3), torch.Generator().manual_seed(0))
    for trunk, head in ((agent.critic, 1.0), (agent.actor, 0.01)):
        for i in (0, 2, 4, 6):
            w = trunk[i].kernel.detach().t().double()          # (out, in)
            gain = head if i == 6 else math.sqrt(2)
            gram = w @ w.t() if w.shape[0] <= w.shape[1] else w.t() @ w
            torch.testing.assert_close(gram, gain ** 2 * torch.eye(gram.shape[0],
                                                                   dtype=torch.float64),
                                       rtol=0, atol=1e-5 * gain ** 2)
            assert torch.count_nonzero(trunk[i].bias) == 0
    assert torch.count_nonzero(agent.log_std) == 0
    again = pb.orthogonal_ppo_init(pb.PPOAgent(9, 3), torch.Generator().manual_seed(0))
    for a, b in zip(agent.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


# -- reading torch checkpoints --------------------------------------------------------------


class _TorchMLP(torch.nn.Module):
    """The reference's MTFNN layout: nn.Linear lin1..linN."""

    def __init__(self, dims):
        super().__init__()
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"lin{i + 1}", torch.nn.Linear(a, b))


class _TorchPPO(torch.nn.Module):
    """The reference's PPO layout: Sequential critic and actor, log_std."""

    def __init__(self, s, a):
        super().__init__()

        def trunk(out):
            return torch.nn.Sequential(torch.nn.Linear(s, 64), torch.nn.Tanh(),
                                       torch.nn.Linear(64, 16), torch.nn.Tanh(),
                                       torch.nn.Linear(16, 32), torch.nn.Tanh(),
                                       torch.nn.Linear(32, out))
        self.critic, self.actor = trunk(1), trunk(a)
        self.log_std = torch.nn.Parameter(torch.full((1, a), 0.1))


def test_load_mtfnn_ckpt_reads_a_torch_file(tmp_path):
    torch.manual_seed(0)
    ref = _TorchMLP([6, 64, 32, 16, 32, 5])
    path = str(tmp_path / "mtfnn_nu.pt")
    torch.save(ref.state_dict(), path)
    model = pb.mtfnn_nu_model(3)
    model.load_state_dict(pb.load_mtfnn_ckpt(path, 5), strict=True)
    X = np.random.default_rng(2).uniform(0, 1, (32, 6)).astype(np.float32)
    jparams = jb.load_mtfnn_ckpt(path, 5)
    want = np.asarray(jb.mtfnn_nu_model(3).apply({"params": jparams}, jnp.asarray(X)))
    with torch.no_grad():
        got = model(torch.from_numpy(X)).numpy()
        h = torch.from_numpy(X)
        for i in range(1, 6):
            h = getattr(ref, f"lin{i}")(h)
            h = torch.relu(h) if i < 5 else h
        own = torch.cat([torch.sigmoid(h[:, :2]), torch.softmax(h[:, 2:], 1)], 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def test_load_ppo_ckpt_reads_a_torch_file(tmp_path):
    torch.manual_seed(1)
    ref = _TorchPPO(6, 5)
    path = str(tmp_path / "ppo_nu.pt")
    torch.save(ref.state_dict(), path)
    agent = pb.PPOAgent(6, 5)
    agent.load_state_dict(pb.load_ppo_ckpt(path), strict=True)
    X = np.random.default_rng(3).uniform(0, 1, (32, 6)).astype(np.float32)
    want = jb.PPOAgent(6, 5).apply({"params": jb.load_ppo_ckpt(path)}, jnp.asarray(X))
    with torch.no_grad():
        got = agent(torch.from_numpy(X))
        own = (ref.critic(torch.from_numpy(X)), ref.actor(torch.from_numpy(X)),
               torch.exp(ref.log_std))
    for w, g, o in zip(want, got, own):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=0, atol=1e-6)


# -- the shipped retrained checkpoints --------------------------------------------------------


@pytest.mark.parametrize("name", ["retrain_mtfnn_co", "retrain_mtfnn_nu", "retrain_ppo_co",
                                  "retrain_ppo_msr_3c", "retrain_ppo_nu"])
def test_retrain_checkpoint_predictions_match_jax(splits, name):
    """``tools/report.py``'s baseline runners, port and JAX, on 256 rows
    of a made split: the predictions and the metrics."""
    algo, fam = name.split("_")[1:3]
    data, jdata = splits[fam]
    for d in (data, jdata):
        d.X_test, d.Y_test = d.X_test[:256], d.Y_test[:256]
    ckpt = str(REPO / "ckpts" / name)
    got = getattr(report, f"run_{algo}")(fam, data, ckpt, torch.device("cpu"))
    want = getattr(jax_report, f"run_{algo}")(fam, jdata, JAX_TASKS[fam], ckpt)
    assert got.shape == want.shape == (256, data.Y_test.shape[1])
    assert _rel(want, got) <= 1e-5
    m = objective_metrics(TASKS[fam], data, got, device="cpu")
    jm = jax_objective_metrics(JAX_TASKS[fam], jdata, np.asarray(want))
    for k in jm:
        assert m[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-9), k


@pytest.mark.parametrize("name", list(CO_PINS))
def test_co_retrain_checkpoints_reproduce_their_pins(name):
    """On the whole remade CO test split, as tests/test_baselines.py pins them."""
    data = TASKS["co"].load(str(CO_CSV))
    algo = name.split("_")[1]
    Y = getattr(report, f"run_{algo}")("co", data, str(REPO / "ckpts" / name),
                                       torch.device("cpu"))
    ratio = objective_metrics(TASKS["co"], data, Y, device="cpu")["exceeded_ratio"]
    assert abs(ratio - CO_PINS[name]) <= 2e-3, ratio


# -- training on JAX's draws ------------------------------------------------------------------


def _train_data(fam, n=256, seed=0):
    """Normalized conditions and labels of the shape each family trains on."""
    rng = np.random.default_rng(seed)
    if fam == "co":
        Y = rng.dirichlet(np.ones(3), n) * (rng.uniform(size=(n, 1)) > 0.1)
        return rng.uniform(0, 1, (n, 9)), Y
    if fam == "msr":
        return rng.uniform(0, 1, (n, 3)), rng.dirichlet(np.ones(3), n)
    return rng.uniform(0, 1, (n, 6)), np.concatenate(
        [rng.uniform(0, 1, (n, 2)), rng.dirichlet(np.ones(3), n)], axis=1)


def _tree_spread(want, got):
    """max |want - got| over the parameters, relative to the largest
    parameter's magnitude. (Per tensor it cannot be held: Adam turns a
    rounding difference on a near-zero gradient into an lr-sized step.)"""
    want, got = params_from_jax(jax.tree.map(np.asarray, want)), params_from_jax(got)
    assert set(want) == set(got)
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((want[k] - got[k]).abs().max()) for k in want) / scale


def _numbers(log):
    return [[float(t) for t in m.split(":", 1)[1].split()[1::2]] for m in log]


@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_train_mtfnn_matches_jax(fam):
    """Two epochs of four steps across a milestone, on the JAX run's init
    and permutations (``train_mtfnn``'s keys: ``split(PRNGKey(seed), 3)``
    for the init, then one ``split`` an epoch)."""
    X, Y = _train_data(fam)
    cfg = dict(epochs=2, batch_size=64, milestones=(1,), seed=3)
    jm = {"co": jb.mtfnn_co_model, "msr": jb.mtfnn_msr_model, "nu": jb.mtfnn_nu_model}[fam]()
    pm = {"co": pb.mtfnn_co_model, "msr": pb.mtfnn_msr_model, "nu": pb.mtfnn_nu_model}[fam]()
    jlog, plog = [], []
    want = jb.train_mtfnn(jm, X, Y, jb.MTFNNConfig(**cfg), log_fn=jlog.append, log_every=1)

    key = jax.random.PRNGKey(cfg["seed"])
    k_init, k_re, key = jax.random.split(key, 3)
    init = jax_torch_style_init(jm.init(k_init, jnp.zeros((1, X.shape[1])))["params"], k_re)
    perms = []
    for _ in range(cfg["epochs"]):
        key, k = jax.random.split(key)
        perms.append(torch.from_numpy(np.asarray(jax.random.permutation(k, X.shape[0]))
                                      .astype(np.int64)))
    got = pb.train_mtfnn(pm, X, Y, pb.MTFNNConfig(**cfg), log_fn=plog.append, log_every=1,
                         init_params=jax.tree.map(np.asarray, init), device="cpu",
                         draws=lambda e: perms[e])
    assert _tree_spread(want, got) <= 1e-5
    np.testing.assert_allclose(_numbers(plog), _numbers(jlog), rtol=0, atol=2e-6)


def _jax_env(fam, cfg_d):
    """The JAX CLI's env_fn and training transform (tools/train_baselines.py:79-128)."""
    from diffsg_tpu.ops import co_cost, nu_decode, nu_rate

    if fam == "msr":
        W, mn, mx = cfg_d["W"], cfg_d["scaler_min"], cfg_d["scaler_max"]

        def env_fn(x, act, y):
            g = x * (mx - mn) + mn
            r = jnp.sum(jnp.log2(1 + act * W * g), axis=1)
            gt = jnp.sum(jnp.log2(1 + y * W * g), axis=1)
            return 1.0 / (jnp.abs(r - gt) + 0.01)
        return env_fn, lambda a: jax.nn.softmax(a, axis=1)
    if fam == "co":
        mn, mx = cfg_d["scaler_min"], cfg_d["scaler_max"]

        def env_fn(x, act, y):
            xs = x * (mx - mn) + mn
            return 1.0 / (jnp.abs(co_cost(xs, act) - co_cost(xs, y)) + 0.1)
        return env_fn, lambda a: jax.nn.softmax(a, axis=1)
    w, h, P = cfg_d["width"], cfg_d["height"], cfg_d["P_sum"]

    def env_fn(x, act, y):
        real = jnp.zeros_like(x)
        return 1.0 / (jnp.abs(nu_rate(act, real) - nu_rate(y, real)) + 0.1)
    return env_fn, lambda a: nu_decode(jax.nn.softmax(a, axis=1), w, h, P)


PPO_CONFIGS = {"co": {"node_num": 3, "scaler_min": 0.0016, "scaler_max": 9.997},
               "msr": {"M": 3, "W": 10.0, "scaler_min": 0.5, "scaler_max": 2.5},
               "nu": {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0}}


@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_train_ppo_matches_jax(fam):
    """Two epochs of three steps (rows trimmed from 200 to 192) with the
    CLI's rewards, on the JAX run's init, first log-probs, permutations and
    action noise, replayed from ``train_ppo``'s keys."""
    X, Y = _train_data(fam, n=200)
    cfg_d = PPO_CONFIGS[fam]
    agent, labels, env_fn, transform, _, _ = train_baselines.ppo_recipe(fam, cfg_d)
    Yl = labels(Y)
    cfg = dict(epochs=2, batch_size=64, milestones=(1,), seed=4)
    ja = jb.PPOAgent(agent.state_dim, agent.action_dim)
    j_env, j_transform = _jax_env(fam, cfg_d)
    jlog, plog = [], []
    want, _ = jb.train_ppo(ja, X, Yl, j_env, j_transform, jb.PPOConfig(**cfg),
                           log_fn=jlog.append, log_every=1)

    B, steps = 64, 3
    n, A = B * steps, agent.action_dim
    key = jax.random.PRNGKey(cfg["seed"])
    k_init, key = jax.random.split(key)
    init = jax.tree.map(np.asarray, jb.orthogonal_ppo_init(ja, k_init))
    k0, key = jax.random.split(key)
    z0 = np.asarray(jax.random.normal(k0, (n, A)))
    draws = []
    for _ in range(cfg["epochs"]):
        key, k = jax.random.split(key)
        k_perm, k_steps = jax.random.split(k)
        perm = np.asarray(jax.random.permutation(k_perm, n)).astype(np.int64)
        noise = np.stack([np.asarray(jax.random.normal(ks, (B, A)))
                          for ks in jax.random.split(k_steps, steps)])
        draws.append(pb.PPODraws(torch.from_numpy(perm), torch.from_numpy(noise)))
    got, info = pb.train_ppo(agent, X, Yl, env_fn, transform, pb.PPOConfig(**cfg),
                             log_fn=plog.append, log_every=1, init_params=init, device="cpu",
                             a0=z0, draws=lambda e: draws[e])
    assert info == {}
    assert _tree_spread(want, got) <= 1e-5
    np.testing.assert_array_equal(got["log_std"], 0.0)           # never optimized
    np.testing.assert_allclose(_numbers(plog), _numbers(jlog), rtol=0, atol=2e-4)


# -- the GEKKO oracle, write_csv, the device rule ------------------------------------------------


def test_gekko_scipy_twins_match_jax(splits):
    data, _ = splits["co"]
    X = TASKS["co"].unnormalize_x(data.X_test[:3], data.config)
    for x in X:
        np.testing.assert_array_equal(gekko_oracle.co_solve_scipy(x), jax_gekko.co_solve_scipy(x))
    g = np.random.default_rng(5).uniform(0.5, 2.5, (3, 3))
    for row in g:
        np.testing.assert_array_equal(gekko_oracle.msr_solve_scipy(row, 10.0),
                                      jax_gekko.msr_solve_scipy(row, 10.0))
    coords = np.random.default_rng(6).uniform(0, 400, 6)
    np.testing.assert_array_equal(gekko_oracle.nu_solve_scipy(coords, 18.0),
                                  jax_gekko.nu_solve_scipy(coords, 18.0))
    assert gekko_oracle.PUBLISHED == jax_gekko.PUBLISHED


def test_gekko_solve_one_needs_gekko():
    try:
        import gekko  # noqa: F401
        pytest.skip("gekko is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="optional 'gekko' package"):
        gekko_oracle._require_gekko()
    with pytest.raises(ImportError):
        gekko_oracle.msr_solve_one(np.ones(3), 10.0)
    with pytest.raises(ImportError):
        jax_gekko.msr_solve_one(np.ones(3), 10.0)


@pytest.mark.parametrize("header", [None, ["a", "b", "c"]])
def test_write_csv_bytes_match_jax(tmp_path, header):
    rows = [[1, 0.5, "x"], [2, 1e-7, "y,z"], [3, float("nan"), ""]]
    write_csv(str(tmp_path / "port" / "t.csv"), rows, header)
    jax_write_csv(str(tmp_path / "jax" / "t.csv"), rows, header)
    assert (tmp_path / "port" / "t.csv").read_bytes() == (tmp_path / "jax" / "t.csv").read_bytes()


@pytest.mark.parametrize("entry", ["train_mtfnn", "train_ppo", "train_baselines", "report",
                                   "fewstep"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    X, Y = _train_data("msr", n=64)
    calls = {
        "train_mtfnn": lambda: pb.train_mtfnn(pb.mtfnn_msr_model(), X, Y),
        "train_ppo": lambda: pb.train_ppo(pb.PPOAgent(3, 3), X, Y, lambda *a: a[0][:, 0],
                                          lambda a: a),
        "train_baselines": lambda: train_baselines.main(
            ["mtfnn", "--task", "co", "--dataset", str(CO_CSV)]),
        "report": lambda: report.main(["--task", "co", "--datasets", str(CO_CSV),
                                       "--baselines", "gd"]),
        "fewstep": lambda: fewstep.main(["--task", "co_ranked", "--ckpt",
                                         str(REPO / "ckpts" / "ddpm_co_x0"),
                                         "--datasets", str(CO_CSV)]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
