"""repro_torch: the PyTorch/CUDA port of the declarative IR system.

It runs on an NVIDIA H100 (``sm_90a``) with hand-written CUDA kernels, and
imports neither JAX nor the JAX package ``repro``, which stays beside it as
the reference.  Entry points run on the card unless the caller passes
``device="cpu"``; without a card and without that argument they raise.

    from repro_torch import Experiment, Retrieve, TorchBackend, build_index
    from repro_torch import DenseRerank, DenseRetrieve, Generate
    from repro_torch import LTRRerank, RM3Expand, CrossValidate, GridSearch
    from repro_torch import MultiPipelineServer, PipelineServer, ServeConfig
"""
from repro_torch.core.compiler import TorchBackend, run_pipeline
from repro_torch.core.data import make_queries
from repro_torch.core.descriptor import BackendDescriptor
from repro_torch.core.engine import ShardedQueryEngine
from repro_torch.core.experiment import Experiment, format_table
from repro_torch.core.ir import Schema, SchemaError, lower, raise_ir
from repro_torch.core.passes import compile_pipeline, explain_pipeline
from repro_torch.core.plan import ArtifactCache, ExperimentPlan
from repro_torch.core.stages import (DenseRerank, DenseRetrieve, Extract,
                                     FatRetrieve, FusedDenseRerank,
                                     FusedDenseRetrieve, Generate, LTRRerank,
                                     MultiRetrieve, Retrieve, RM3Expand,
                                     SDMRewrite, StemRewrite)
from repro_torch.core.tuning import CrossValidate, GridSearch
from repro_torch.index import (build_index, expand_topics, index_from_arrays,
                               synthesize_corpus, synthesize_topics)
from repro_torch.serve import (DeadlineUnmeetable, MultiPipelineServer,
                               PipelineServer, ServeConfig, StageResultCache)

__all__ = [
    "TorchBackend", "BackendDescriptor", "ShardedQueryEngine",
    "compile_pipeline",
    "explain_pipeline", "run_pipeline", "lower", "raise_ir",
    "Schema", "SchemaError", "make_queries", "Experiment", "format_table",
    "ExperimentPlan", "ArtifactCache", "GridSearch", "CrossValidate",
    "Retrieve", "MultiRetrieve", "FatRetrieve", "Extract", "DenseRetrieve",
    "DenseRerank", "FusedDenseRetrieve", "FusedDenseRerank", "LTRRerank",
    "RM3Expand", "SDMRewrite", "StemRewrite", "Generate", "build_index",
    "expand_topics", "index_from_arrays", "synthesize_corpus",
    "synthesize_topics", "PipelineServer", "MultiPipelineServer",
    "ServeConfig", "DeadlineUnmeetable", "StageResultCache",
]
