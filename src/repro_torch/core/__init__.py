"""HAP core of the port: the planner (strategy space, cost models, ILP),
the session facade, INT4 quantization and the Eq.-6 transition. Copies of
``repro.core``'s framework-free modules, plus a torch transition executor."""
from .flops import Workload  # noqa: F401
from .hap import HAPPlan, HAPPlanner, fixed_plan  # noqa: F401
from .session import (FixedPlanSource, HAPSession,  # noqa: F401
                      IlpPlanSource, PlanSource, StaticPlanSource,
                      WorkloadBucket)
from .hardware import CHIPS, ChipSpec, GroundTruth, get_chip  # noqa: F401
from .ilp import HapIlp  # noqa: F401
from .latency import InferenceSimulator, LatencyModel  # noqa: F401
from .strategy import (AttnStrategy, ExpertStrategy,  # noqa: F401
                       attention_strategies, expert_strategies)
from .transition import (TransitionExecutor, transition_costs,  # noqa: F401
                         switching_matrix)
