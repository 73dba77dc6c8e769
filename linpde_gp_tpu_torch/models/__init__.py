"""GP models of the port: random variables and processes, the dense
conditioning engine and the gram-free regressor."""

from . import functions, randvars
from .gp import ConditionalGaussianProcess, GaussianProcess
from .iterative import IterativeGPRegressor
from .randprocs import DeterministicProcess, asrandproc
from .randvars import Constant, Normal, RandomVariable, asrandvar

__all__ = [
    "functions",
    "randvars",
    "GaussianProcess",
    "ConditionalGaussianProcess",
    "IterativeGPRegressor",
    "DeterministicProcess",
    "asrandproc",
    "Normal",
    "Constant",
    "RandomVariable",
    "asrandvar",
]
