"""On the card: the control (the reference in the program's place with
its products' operands rounded to float8 e4m3) and the planted fault
"half of each micro-batch" fail the check against the float32 reference,
at a size a test run holds (the tiny post-LN cell's batches, which the
reference assembles; the port's kernels take no head dims this small, so
the port does not run here). ``python -m pytest benchmark/tests -m gpu``
runs it on the GPU machine; it skips elsewhere."""

import pytest
import torch

from benchmark import check, run, weights, work
from benchmark.reference import model as ref_model
from benchmark.reference import train as reference
from benchmark.tests.tiny import make_root
from benchmark.traffic.generator import make_corpus


@pytest.mark.gpu
def test_control_and_half_fail_the_check(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    cell = run.load_cell("tiny-post.raw", make_root(tmp_path))
    cfg, settings = cell["cfg"], cell["settings"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (1, 2, 3):
        corpus = make_corpus(cell["traffic"]["corpus"], run.corpus_seed(seed))
        assemble = work.load("reference/assemblers", cfg["assembler"])
        order = assemble.loader_order(len(corpus[1]), 4, seed)
        asm = assemble.Assembler(*corpus, settings)
        batches = [asm.batch(ix) for ix in order[:run.CHECK_UPDATES]]

        def ref_run(**kw):
            return reference.run(cfg, settings,
                                 weights.make_weights(cfg, settings, seed,
                                                      device),
                                 batches, seed, device, **kw)

        ref = ref_run()
        for kw in (dict(prec=ref_model.Precision(fp8=True)),
                   dict(half=True)):
            got = check.numbers(check.as_readings(ref_run(**kw), batches),
                                ref)
            print(seed, kw, got)
            assert not check.verdict(got, cell["check"]["limits"]), (kw, got)
