"""Autoregressive actor-critic for QC-LDPC code search (the port of
``ldpc_tpu.rl.model``; ``torch.nn`` in place of flax).

Replicates the reference policy structure (``models.py:278-513``):

* an MLP encoder over the 2048-byte packed observation;
* an autoregressive chain of categorical heads — block row ``i`` (2-way),
  block col ``j`` (16-way, conditioned on i), hot-bit count ``k``
  (``max_hot``-way, sampled value offset by +1 so k >= 1,
  models.py:363-372), then ``max_hot`` coordinate choices from a 511-way
  categorical whose logits feed back additively into its own input
  (``setEncodedStuff = setEncodedStuff + logits``, models.py:398-430);
* a separate MLP critic over the raw observation (models.py:456).

Like the reference, the total log-prob sums ALL ``max_hot`` coordinate
heads (even the unused ones beyond k, models.py:437-447), and per-head
entropies are returned so PPO can apply its entropy term to the i-head
only (openAIppo.py:337).

As in the JAX package, hidden activations default to tanh (the
reference's ``explicitMLP`` defaults to ``nn.Identity``, models.py:83:
pass ``activation="identity"`` to reproduce), and each coordinate is one
categorical draw.

The port's own choices:

* **Layout.** ``MLP.dense[i]`` is flax's ``Dense_i``; a ``Linear.weight``
  is the transpose of a flax kernel (``[in, out]``).  The Actor's
  sub-modules keep the flax names (``encoder``, ``i_head``, ``j_head``,
  ``k_head``, ``encoder2``, ``coord_head``); the Critic's MLP is ``mlp``
  (flax ``MLP_0``).  ``params_from_jax`` carries flax weights across.
* **Initialisation.** ``init_params`` draws as flax's ``Dense`` does:
  lecun-normal kernels (a normal truncated at two standard deviations,
  variance 1/fan_in) and zero biases.  The draws come from a
  ``torch.Generator`` on the CPU, so they match flax's in distribution
  only, and are the same whatever the device.
* **Sampling.** ``Actor.sample(obs, generator)`` takes one generator per
  row (or one for all): each row draws its uniform noise, of one fixed
  width (``noise_width``), from its own generator, and every head samples
  by Gumbel-max (``argmax(logits + Gumbel)``, as ``jax.random.categorical``
  does).  A batch of rows, each with its own generator, therefore draws
  what the rows would draw one at a time, so a vector rollout equals a
  sequential one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device

__all__ = ["ActorCriticConfig", "MLP", "Actor", "Critic", "sample_step",
           "evaluate_actions", "action_to_env_action", "init_params",
           "params_from_jax", "noise_width"]

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
                "identity": lambda x: x}
# flax's variance_scaling "truncated_normal": the standard deviation of a
# unit normal truncated to [-2, 2], which the draw's scale is divided by
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ActorCriticConfig:
    obs_dim: int = 2048
    hidden: int = 64              # hiddenEncoderSize (openAIppo.py:288)
    row_range: int = 2
    col_range: int = 16
    z: int = 511
    max_hot: int = 15             # MAXIMUM_NUMBER_OF_HOT_BITS
    activation: str = "tanh"

    @property
    def x_bits(self) -> int:
        return max(1, (self.row_range - 1).bit_length())

    @property
    def y_bits(self) -> int:
        return max(1, (self.col_range - 1).bit_length())

    @property
    def buffer_action_dim(self) -> int:
        """[i, j, k, coords...] as stored in the PPO buffer
        (models.py:489)."""
        return 3 + self.max_hot

    @property
    def env_action_dim(self) -> int:
        return self.x_bits + self.y_bits + self.z

    @property
    def num_entropy_heads(self) -> int:
        return 3 + self.max_hot


def noise_width(cfg: ActorCriticConfig) -> int:
    """Uniform draws a row's sample takes: the i, j and k heads' and then
    ``max_hot`` coordinate heads' (fixed, whatever is sampled)."""
    return cfg.row_range + cfg.col_range + cfg.max_hot + cfg.max_hot * cfg.z


class MLP(nn.Module):
    """explicitMLP equivalent (models.py:77-103): hidden stack + linear
    out; ``dense[i]`` is flax's ``Dense_i``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: str = "tanh"):
        super().__init__()
        widths = [in_features, *features]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in
                                   zip(widths[:-1], widths[1:]))
        self.activation = activation

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        for layer in self.dense[:-1]:
            x = act(layer(x))
        return self.dense[-1](x)


def _column(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)[..., None]


def _pick(logp_all: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(-1, value[..., None])[..., 0]


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    return -(torch.softmax(logits, -1) *
             torch.log_softmax(logits, -1)).sum(-1)


class Actor(nn.Module):
    """Autoregressive policy.  ``forward(obs, action)`` evaluates the
    given buffer actions; ``sample``/``mode`` draw new ones."""

    def __init__(self, cfg: ActorCriticConfig):
        super().__init__()
        c = self.cfg = cfg
        a = c.activation
        self.encoder = MLP(c.obs_dim, [c.hidden, c.hidden, c.hidden], a)
        self.i_head = MLP(c.hidden, [64, c.row_range], a)
        self.j_head = MLP(c.hidden + 1, [64, c.col_range], a)
        self.k_head = MLP(c.hidden + 2, [64, c.max_hot], a)
        self.encoder2 = MLP(c.hidden + 3, [64, c.z], a)
        self.coord_head = MLP(c.z, [64, c.z], a)

    def _chain(self, obs, pick_i, pick_j, pick_k, pick_coord):
        """The autoregressive chain (models.py:312-447).  ``pick_*(logits)``
        chooses each head's value (k: its index, stored +1), and
        ``pick_coord(logits, t)`` coordinate t's."""
        enc = self.encoder(obs)
        li = self.i_head(enc)
        i = pick_i(li)
        enc_i = torch.cat([enc, _column(i)], -1)
        lj = self.j_head(enc_i)
        j = pick_j(lj)
        enc_ij = torch.cat([enc_i, _column(j)], -1)
        lk = self.k_head(enc_ij)
        # k can't be 0: index + 1 (models.py:367-369)
        k = pick_k(lk) + 1
        carry = self.encoder2(torch.cat([enc_ij, _column(k)], -1))
        coords, logps, ents = [], [], []
        for t in range(self.cfg.max_hot):
            logits = self.coord_head(carry)
            logp_all = torch.log_softmax(logits, -1)
            coord = pick_coord(logits, t)
            logps.append(_pick(logp_all, coord))
            ents.append(-(torch.softmax(logits, -1) * logp_all).sum(-1))
            coords.append(coord)
            carry = carry + logits
        # k is stored offset by +1; log-prob evaluated at k-1
        # (models.py:440-441)
        logp_heads = [_pick(torch.log_softmax(li, -1), i),
                      _pick(torch.log_softmax(lj, -1), j),
                      _pick(torch.log_softmax(lk, -1),
                            torch.clamp_min(k - 1, 0))]
        ent_heads = [_entropy(li), _entropy(lj), _entropy(lk)]
        logp_all = torch.stack(logp_heads + logps, -1)
        ent_all = torch.stack(ent_heads + ents, -1)
        return {"i": i, "j": j, "k": k, "coords": torch.stack(coords, -1),
                "logp": logp_all.sum(-1), "logp_per_head": logp_all,
                "entropy": ent_all.sum(-1), "entropy_per_head": ent_all}

    def forward(self, obs, action):
        """Log-probs/entropies of given buffer actions [i, j, k,
        coords...] (the `action is not None` mode, models.py:312-447)."""
        action = action.to(torch.int64)
        out = self._chain(obs, lambda _: action[..., 0],
                          lambda _: action[..., 1],
                          lambda _: action[..., 2] - 1,
                          lambda _, t: action[..., 3 + t])
        del out["coords"]
        return out

    def sample(self, obs, generator):
        """Sample an action (training mode, models.py:351-430).
        ``generator``: a ``torch.Generator`` on ``obs``'s device, or one per
        row; row r draws ``noise_width`` uniforms from its own."""
        c = self.cfg
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator] * obs.shape[0])
        if len(gens) != obs.shape[0]:
            raise ValueError(f"{len(gens)} generators for {obs.shape[0]} "
                             "rows")
        width = noise_width(c)
        u = torch.stack([torch.rand(width, generator=g, device=obs.device)
                         for g in gens])
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        ends = np.cumsum([c.row_range, c.col_range, c.max_hot])
        g_i, g_j, g_k = (gumbel[:, :ends[0]], gumbel[:, ends[0]:ends[1]],
                         gumbel[:, ends[1]:ends[2]])
        g_c = gumbel[:, ends[2]:].reshape(-1, c.max_hot, c.z)
        return self._chain(
            obs, lambda li: torch.argmax(li + g_i, -1),
            lambda lj: torch.argmax(lj + g_j, -1),
            lambda lk: torch.argmax(lk + g_k, -1),
            lambda logits, t: torch.argmax(logits + g_c[:, t], -1))

    def mode(self, obs):
        """Most probable action (eval mode, models.py:357-359,426-430)."""
        def best(logits, *_):
            return torch.argmax(logits, -1)
        return self._chain(obs, best, best, best, best)


class Critic(nn.Module):
    """Value MLP over the raw observation (models.py:456)."""

    def __init__(self, cfg: ActorCriticConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp = MLP(cfg.obs_dim, [cfg.hidden, cfg.hidden, 1],
                       cfg.activation)

    def forward(self, obs):
        return self.mlp(obs)[..., 0]


def _lecun_normal(module: nn.Module, gen: torch.Generator) -> None:
    """flax ``Dense``'s initialisation, in module order."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
            with torch.no_grad():
                w = torch.empty(layer.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()


def init_params(cfg: ActorCriticConfig, seed: int = 0, device=None):
    """A new (actor, critic) on ``device`` (default: the card), initialised
    as flax's ``Dense`` layers are, from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    actor, critic = Actor(cfg), Critic(cfg)
    _lecun_normal(actor, gen)
    _lecun_normal(critic, gen)
    return actor.to(dev), critic.to(dev)


def params_from_jax(actor_params, critic_params) -> tuple[dict, dict]:
    """The JAX package's flax parameter trees (nested dicts of arrays, as
    ``ldpc_tpu.rl.init_params`` returns them or their ``"params"``
    entries) -> (actor, critic) ``state_dict``s of float32 CPU tensors:
    ``Dense_i`` -> ``dense.i``, kernel -> ``weight`` transposed, the
    Critic's ``MLP_0`` -> ``mlp``."""
    def convert(tree, rename):
        tree = tree.get("params", tree)
        out = {}
        for name, mlp in tree.items():
            for dense, leaf in mlp.items():
                prefix = f"{rename.get(name, name)}.dense.{int(dense[6:])}"
                out[prefix + ".weight"] = torch.tensor(
                    np.asarray(leaf["kernel"], np.float32).T.copy())
                out[prefix + ".bias"] = torch.tensor(
                    np.asarray(leaf["bias"], np.float32))
        return out

    return convert(actor_params, {}), convert(critic_params,
                                              {"MLP_0": "mlp"})


def sample_step(cfg: ActorCriticConfig, actor: Actor, critic: Critic, obs,
                generator=None, deterministic: bool = False):
    """One acting step: (buffer_action [B, 3 + max_hot] int64, value,
    logp, entropies per head) — the openAIActorCritic.step contract
    (models.py:476-513).  ``generator`` as in ``Actor.sample`` (unused
    when ``deterministic``)."""
    with torch.no_grad():
        out = actor.mode(obs) if deterministic else actor.sample(
            obs, generator)
        v = critic(obs)
    buffer_action = torch.cat(
        [torch.stack([out["i"], out["j"], out["k"]], -1), out["coords"]],
        -1)
    return buffer_action, v, out["logp"], out["entropy_per_head"]


def evaluate_actions(cfg: ActorCriticConfig, actor: Actor, obs, actions):
    """Log-probs/entropies of stored actions (PPO update path)."""
    return actor(obs, actions)


def action_to_env_action(cfg: ActorCriticConfig, buffer_action) -> np.ndarray:
    """[i, j, k, coords...] -> 516-bit env action
    (models.py:301-310,486-497): big-endian x/y bits + k-hot vector from
    the first k coordinates."""
    a = np.asarray(buffer_action).reshape(-1)
    i, j, k = int(a[0]), int(a[1]), int(a[2])
    coords = a[3:3 + k].astype(np.int64)
    vec = np.zeros(cfg.z, np.int32)
    vec[coords] = 1
    xb = [int(b) for b in np.binary_repr(i, cfg.x_bits)]
    yb = [int(b) for b in np.binary_repr(j, cfg.y_bits)]
    return np.concatenate([xb, yb, vec]).astype(np.int32)
