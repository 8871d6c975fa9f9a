"""RL algorithms of the port: losses, advantages, the PPO critic and the
GRPO / PPO / DAPO trainer."""
