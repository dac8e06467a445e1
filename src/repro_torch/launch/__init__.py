"""Launchers: the Track-B training CLI (`train`), elastic state surgery
(`elastic`), and the sharded Track-A engine's process layout over
torch.distributed (`mesh`)."""
