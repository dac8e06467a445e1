"""Track-B launchers: the training CLI (`train`) and elastic state surgery
(`elastic`)."""
