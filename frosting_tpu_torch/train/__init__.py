"""Trainers: the stage-1 3DGS trainer, its Adam, densification and
checkpoints, and the stage-2 SuGaR trainer."""
