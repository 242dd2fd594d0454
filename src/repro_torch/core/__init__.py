"""Declarative IR pipeline framework on PyTorch: the paper's stage set,
compiler, Experiment planner and tuning (grid search, cross-validation),
the dense second stage and the RAG answer stage.

    from repro_torch.core import *
    be = TorchBackend(build_index(synthesize_corpus()))
    pipe = Retrieve("BM25") % 10
    res = Experiment([pipe], topics, qrels, ["map"], backend=be)
"""
from repro_torch.core.compiler import Context, TorchBackend, run_pipeline  # noqa: F401
from repro_torch.core.data import make_queries  # noqa: F401
from repro_torch.core.descriptor import BackendDescriptor, TuningProfile  # noqa: F401
from repro_torch.core.engine import ShardedQueryEngine, StageProgram  # noqa: F401
from repro_torch.core.experiment import Experiment, format_table  # noqa: F401
from repro_torch.core.ir import Op, Schema, SchemaError, lower, raise_ir  # noqa: F401
from repro_torch.core.passes import (AutotunePass, compile_pipeline,  # noqa: F401
                                     explain_pipeline)
from repro_torch.core.plan import ArtifactCache, ExperimentPlan  # noqa: F401
from repro_torch.core.stages import (DenseRerank, DenseRetrieve,  # noqa: F401
                                     Extract, FatRetrieve, FusedDenseRerank,
                                     FusedDenseRetrieve, FusedFatRetrieve,
                                     FusedTopKRetrieve, Generate, LTRRerank,
                                     MultiRetrieve, PrunedRetrieve, Retrieve,
                                     RM3Expand, SDMRewrite, StemRewrite)
from repro_torch.core.transformer import Transformer  # noqa: F401
from repro_torch.core.tuning import CrossValidate, GridSearch  # noqa: F401
