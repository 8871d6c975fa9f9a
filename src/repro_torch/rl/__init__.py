"""RL algorithms of the port: losses, advantages and the GRPO trainer."""
