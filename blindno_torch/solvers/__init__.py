"""PDE solvers: the Fokker-Planck master equation and the split-step GPE."""
