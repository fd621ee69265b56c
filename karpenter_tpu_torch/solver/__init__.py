from .driver import SolverConfig, TorchSolver

__all__ = ["TorchSolver", "SolverConfig"]
