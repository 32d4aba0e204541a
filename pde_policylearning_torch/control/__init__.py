from .ddpg import (Actor, Critic, DDPGAgent, PendulumEnv, ReplayMemory,
                   make_ddpg_policy, train_ddpg_channel_on_device,
                   train_pendulum)
from .gym_env import ChannelGymEnv, train_ddpg_channel
from .loop import closed_loop_chunk, run_closed_loop
from .policies import (StatefulPolicy, make_fullfield_optimal_observer,
                       make_optimal_policy_observer, make_policy)

__all__ = ["make_policy", "closed_loop_chunk", "run_closed_loop",
           "StatefulPolicy", "make_optimal_policy_observer",
           "make_fullfield_optimal_observer", "Actor", "Critic", "DDPGAgent",
           "PendulumEnv", "ReplayMemory", "make_ddpg_policy",
           "train_ddpg_channel_on_device", "train_pendulum",
           "ChannelGymEnv", "train_ddpg_channel"]
