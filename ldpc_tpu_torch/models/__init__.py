"""Model zoo index — the reference keeps its actor/critic networks in a
top-level ``models.py`` (models.py:77-513); here they live with the RL
stack (``ldpc_tpu_torch/rl/model.py`` / ``rl/continuous.py``) and this
package re-exports them under the conventional ``models`` name, as the JAX
package's ``models`` does."""

from ..rl.continuous import (DeterministicActor, GaussianActor, QCritic,
                             SquashedGaussianActor, ValueCritic)
from ..rl.model import (MLP, Actor, ActorCriticConfig, Critic,
                        action_to_env_action, init_params)

__all__ = [
    "MLP",
    "Actor",
    "ActorCriticConfig",
    "Critic",
    "DeterministicActor",
    "GaussianActor",
    "QCritic",
    "SquashedGaussianActor",
    "ValueCritic",
    "action_to_env_action",
    "init_params",
]
