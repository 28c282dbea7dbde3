"""Word2Vec's run-to-run spread on the card: ``Word2Vec()`` at its defaults
fitted four times on each of ``chip_smoke.py``'s tweet sizes (twice with
its steps replayed in captured blocks, twice with the blocks eager through
``chip_smoke.eager_plain_programs``), printing max |v_a - v_b| / max|v| for
replayed vs eager, eager vs eager and replayed vs replayed.  ``index_add_``
on a CUDA tensor adds in atomic order, so two fits of the same code differ,
and the difference grows with the epoch's steps.

    python3 tools/w2v_spread.py [--sizes 100000 20000 2000]

Run from the repository root on a machine with a CUDA card.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import chip_smoke as cs
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.featurize import word2vec as w2v
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[100_000, 20_000, 2_000])
    args = ap.parse_args()
    print(cs.nvidia_smi(), flush=True)
    kw = dict(input_col="text", output_col="vec")
    for n in args.sizes:
        df, _, _ = cs.w2v_frame(n, 171)
        out = {}
        for label in ("replayed", "replayed2", "eager", "eager2"):
            ctx = cs.eager_plain_programs(w2v) if label.startswith("eager") \
                else cs.contextlib.nullcontext()
            with ctx:
                m = Word2Vec(**kw).fit(df)
            out[label] = np.asarray(m.get("vectors"))
        vmax = float(np.abs(out["eager"]).max())

        def rel(a, b):
            return float(np.abs(out[a] - out[b]).max()) / vmax
        print(f"{n} tweets: {m.fit_stats['steps']} steps, vocabulary "
              f"{m.fit_stats['vocab']}; x max|v|: replayed vs eager "
              f"{rel('replayed', 'eager'):.3e}, {rel('replayed2', 'eager2'):.3e};"
              f" eager vs eager {rel('eager', 'eager2'):.3e}; replayed vs "
              f"replayed {rel('replayed', 'replayed2'):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
