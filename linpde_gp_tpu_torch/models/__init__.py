"""GP models of the port: functions, domains, random variables and
processes, the dense conditioning engine, the gram-free regressor and the
PDE problems."""

from . import domains, functions, problems, randvars
from .gp import ConditionalGaussianProcess, GaussianProcess
from .iterative import IterativeGPRegressor
from .parametric import ParametricGaussianProcess
from .randprocs import DeterministicProcess, asrandproc
from .randvars import Constant, Normal, RandomVariable, asrandvar

__all__ = [
    "domains",
    "functions",
    "problems",
    "randvars",
    "GaussianProcess",
    "ConditionalGaussianProcess",
    "ParametricGaussianProcess",
    "IterativeGPRegressor",
    "DeterministicProcess",
    "asrandproc",
    "Normal",
    "Constant",
    "RandomVariable",
    "asrandvar",
]
