from .registry import all_stage_classes, instantiate_default
from .codegen import generate_stub_file, generate_docs, generate_all
from .testgen import generate_tests
from .rgen import generate_r_classes

__all__ = ["all_stage_classes", "instantiate_default", "generate_stub_file",
           "generate_docs", "generate_all", "generate_tests", "generate_r_classes"]
