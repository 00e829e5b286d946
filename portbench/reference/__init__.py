"""The plain reference: the GP Bayesian-optimisation mathematics the
configurations state, written again in plain PyTorch (float64 by default)
from the configuration files and the benchmark's own inputs. It imports
nothing of the program under test and takes nothing the program made."""
