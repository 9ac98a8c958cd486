"""The update step's gradients on the card against the CPU, at full width.

``ActorCriticConfig()``'s actor-critic from ``init_params(seed)`` on both
devices and one batch of random observation bytes, raw and / 255; the
actions sampled on the card.  Each device takes one PPO policy step and
one value step (``make_update_fns``) from fresh Adam optimisers.  For
every parameter the script reports the largest |card - CPU| gradient
over the tensor's largest |CPU| gradient (``rel``), and the largest ratio
of |card - CPU| to ``rtol`` x |CPU| + ``atol`` x the tensor's largest
|CPU| (``excess``; above 1 fails ``chip_smoke.py`` phase 14 (c), whose
``GRAD_RTOL``/``GRAD_ATOL`` are the defaults here).

On the machine with the card::

    python -m ldpc_tpu_torch.scripts.grad_parity [--seed 2] [--rows 16]

prints one JSON line: the card's name and, for each scale, every
parameter's ``rel`` and ``excess`` and the largest of each.
"""

from __future__ import annotations

import argparse
import json


def measure(seed: int, rows: int, rtol: float, atol: float) -> dict:
    import numpy as np
    import torch

    from ..rl import (ActorCriticConfig, PPOConfig, env_generators,
                      evaluate_actions, init_params, make_update_fns,
                      sample_step)

    card = torch.device("cuda", torch.cuda.current_device())
    cfg = ActorCriticConfig()
    raw = np.random.default_rng(seed).integers(
        0, 256, (rows, cfg.obs_dim)).astype(np.float32)
    out = {"card": torch.cuda.get_device_name(card), "scales": {}}
    for scale in (1.0, 255.0):
        rng = np.random.default_rng(seed + 1)
        obs = torch.tensor(raw / scale)
        adv = torch.tensor(rng.standard_normal(rows).astype(np.float32))
        ret = torch.tensor(rng.standard_normal(rows).astype(np.float32))
        nets = {d: init_params(cfg, seed=seed, device=d)
                for d in ("cpu", card)}
        act = sample_step(cfg, *nets[card], obs.to(card),
                          env_generators(seed, rows, card))[0].cpu()
        logp_old = evaluate_actions(cfg, nets["cpu"][0], obs,
                                    act)["logp"].detach()
        pi_opt, vf_opt, pi_up, v_up = make_update_fns(cfg, PPOConfig())
        for d, (actor, critic) in nets.items():
            pi_up(actor, pi_opt(actor.parameters()), obs.to(d), act.to(d),
                  adv.to(d), logp_old.to(d))
            v_up(critic, vf_opt(critic.parameters()), obs.to(d), ret.to(d))
        rows_out = {}
        for net, i in (("actor", 0), ("critic", 1)):
            for (k, p), q in zip(nets[card][i].named_parameters(),
                                 nets["cpu"][i].parameters()):
                w, g = q.grad, p.grad.cpu()
                largest = float(w.abs().max())
                diff = (g - w).abs()
                tol = (rtol * w.abs() + atol * largest).clamp_min(1e-30)
                rows_out[f"{net}.{k}"] = {
                    "rel": float(diff.max()) / max(largest, 1e-30),
                    "excess": float((diff / tol).max())}
        out["scales"][f"obs/{scale:g}"] = {
            "max_rel": max(r["rel"] for r in rows_out.values()),
            "max_excess": max(r["excess"] for r in rows_out.values()),
            "params": rows_out}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--atol", type=float, default=3e-5)
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.seed, a.rows, a.rtol, a.atol)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
