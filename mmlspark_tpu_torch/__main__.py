"""``python -m mmlspark_tpu_torch <command>`` — package tool entry points.

Commands:
  codegen [out_dir]      regenerate the codegen artifacts (default
                         mmlspark_tpu_torch/_generated)
  graft-lint [args...]   the static-analysis gate (alias: lint, analysis):
                         not yet ported (ROADMAP §1 item 14)
  help                   this message
"""
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv.pop(0) if argv else "help"
    if cmd in ("graft-lint", "lint", "analysis"):
        raise NotImplementedError(
            f"{cmd}: the static-analysis gate's checkers name JAX/Pallas "
            "idioms; its torch/CUDA twin is ROADMAP §1 item 14, not yet "
            "ported")
    if cmd == "codegen":
        from .codegen.codegen import DEFAULT_OUT_DIR, generate_all
        generate_all(argv[0] if argv else DEFAULT_OUT_DIR)
        return 0
    print(__doc__.strip())
    return 0 if cmd in ("help", "-h", "--help") else 2


if __name__ == "__main__":
    sys.exit(main())
