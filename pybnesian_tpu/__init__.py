"""pybnesian_tpu: a JAX-native Bayesian-network learning and inference
framework.

Flat public API mirroring the reference's single extension module
(reference pybnesian/lib.cpp:22-51): graphs, factors, models, scores,
independence tests, operators, and learning algorithms all importable from
the package root. The numeric core runs on JAX/XLA (see pybnesian_tpu.ops);
the posterior-inference engine (pybnesian_tpu.inference) is new to this
framework.
"""

from .data import CrossValidation, DataFrame, HoldOut
from .data.dynamic import DynamicDataFrame, DynamicVariable
from .graph import (
    ConditionalDag,
    ConditionalDirectedGraph,
    ConditionalPartiallyDirectedGraph,
    ConditionalUndirectedGraph,
    Dag,
    DirectedGraph,
    PartiallyDirectedGraph,
    UndirectedGraph,
)
from .factors import (
    Args,
    Arguments,
    Assignment,
    DiscreteFactor,
    DiscreteFactorType,
    Factor,
    FactorType,
    Kwargs,
    LinearGaussianCPD,
    LinearGaussianCPDType,
    UnknownFactorType,
)
from .factors.ckde import CKDE, CKDEType
from .factors.hybrid import CLinearGaussianCPD, HCKDE
from .kde import (
    KDE,
    BandwidthSelector,
    NormalReferenceRule,
    ProductKDE,
    ScottsBandwidth,
)
from .kde.ucv import UCV, UCVScorer
from .models import (
    BayesianNetwork,
    BayesianNetworkBase,
    BayesianNetworkType,
    CLGNetwork,
    CLGNetworkType,
    ConditionalBayesianNetwork,
    ConditionalCLGNetwork,
    ConditionalDiscreteBN,
    ConditionalGaussianNetwork,
    ConditionalHeterogeneousBN,
    ConditionalHomogeneousBN,
    ConditionalKDENetwork,
    ConditionalSemiparametricBN,
    DiscreteBN,
    DiscreteBNType,
    GaussianNetwork,
    GaussianNetworkType,
    HeterogeneousBN,
    HeterogeneousBNType,
    HomogeneousBN,
    HomogeneousBNType,
    KDENetwork,
    KDENetworkType,
    SemiparametricBN,
    SemiparametricBNType,
)
from .models.dynamic import (
    DynamicBayesianNetwork,
    DynamicCLGNetwork,
    DynamicDiscreteBN,
    DynamicGaussianNetwork,
    DynamicHeterogeneousBN,
    DynamicHomogeneousBN,
    DynamicKDENetwork,
    DynamicSemiparametricBN,
)
from .learning.scores import BIC, Score, ValidatedScore
from .learning.scores.bde import BDe
from .learning.scores.bge import BGe
from .learning.scores.likelihood import (
    CVLikelihood,
    HoldoutLikelihood,
    ValidatedLikelihood,
)
from .learning.scores.dynamic import (
    DynamicBDe,
    DynamicBGe,
    DynamicBIC,
    DynamicCVLikelihood,
    DynamicHoldoutLikelihood,
    DynamicScore,
    DynamicValidatedLikelihood,
)
from .learning.operators import (
    AddArc,
    ArcOperator,
    ArcOperatorSet,
    ChangeNodeType,
    ChangeNodeTypeSet,
    FlipArc,
    LocalScoreCache,
    Operator,
    OperatorPool,
    OperatorSet,
    OperatorTabuSet,
    RemoveArc,
)
from .learning.parameters import (
    MLE,
    MLEDiscreteFactor,
    MLELinearGaussianCPD,
    LinearGaussianParams,
)
from .factors.discrete import DiscreteParams as DiscreteFactorParams
from .learning.algorithms import Callback, GreedyHillClimbing, SaveModel, hc
from .learning.algorithms.pc import PC, MeekRules
from .learning.algorithms.mmpc import MMPC
from .learning.algorithms.mmhc import MMHC
from .learning.algorithms.dmmhc import DMMHC
from .learning.independences import (
    ChiSquare,
    DynamicIndependenceTest,
    IndependenceTest,
    KMutualInformation,
    LinearCorrelation,
    MutualInformation,
    RCoT,
)
from .learning.independences.chi_square import DynamicChiSquare
from .learning.independences.hybrid_mi import DynamicMutualInformation
from .learning.independences.kmutual_info import DynamicKMutualInformation
from .learning.independences.linearcorrelation import DynamicLinearCorrelation
from .learning.independences.rcot import DynamicRCoT
from .kdtree import KDTree
from .utils.pickle import load

# Interface-compatible aliases (the reference exposes dedicated base classes;
# here the generic classes serve as both, models/base.py)
ConditionalBayesianNetworkBase = ConditionalBayesianNetwork
DynamicBayesianNetworkBase = DynamicBayesianNetwork

__version__ = "0.3.0"


def install_as_pybnesian() -> None:
    """Register this package under the name ``pybnesian`` so existing
    PyBNesian code (and its test suites) run unmodified::

        import pybnesian_tpu
        pybnesian_tpu.install_as_pybnesian()
        import pybnesian as pbn   # -> pybnesian_tpu

    ``import pybnesian.<sub>`` also resolves to the SAME module objects (a
    meta-path alias, not a copy — duplicating the tree would fork jit
    caches and singleton type identities). No-op if a module named
    ``pybnesian`` is already imported."""
    import importlib
    import importlib.abc
    import importlib.util
    import sys

    if "pybnesian" in sys.modules and sys.modules["pybnesian"] is not (
        sys.modules[__name__]
    ):
        return
    sys.modules["pybnesian"] = sys.modules[__name__]

    class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        def find_spec(self, fullname, path=None, target=None):
            if fullname.startswith("pybnesian."):
                return importlib.util.spec_from_loader(fullname, self)
            return None

        def create_module(self, spec):
            real = "pybnesian_tpu" + spec.name[len("pybnesian"):]
            return importlib.import_module(real)

        def exec_module(self, module):
            pass

    if not any(type(f).__name__ == "_AliasFinder" for f in sys.meta_path):
        sys.meta_path.insert(0, _AliasFinder())


__all__ = [name for name in dir() if not name.startswith("_")]
