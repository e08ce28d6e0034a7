"""One bf16 case per generation family, held to the reference's own bf16
bound of ``6e-2`` (``tests/test_serving.py``): logits, prefill with its
cache, and ragged decode steps, as ``tests/test_torch_families.py``
checks them in fp32 (its ``answers`` says how the reference is run and
``check_prefill`` which cache entries a bf16 prefill is held to).  A
file of its own: the reference runs op by op here, and its first call of
each operation compiles, so the compiled operations are kept across the
cases (``tests/conftest.py`` releases them after the module).
"""
import pytest
import torch

from test_torch_families import (answers, check_decode, check_logits,
                                 check_prefill)

torch.set_num_threads(1)

CASES = {
    "gemma3": "gemma3-1b",
    "qwen2-moe": "qwen2-moe-a2.7b",
    "falcon-mamba": "falcon-mamba-7b",
    "zamba2": "zamba2-2.7b",
    "whisper": "whisper-medium",
}


@pytest.fixture(scope="module", params=list(CASES))
def fam(request):
    return answers(CASES[request.param], {})


def test_logits_match_reference_bf16(fam):
    check_logits(fam)


def test_prefill_matches_reference_bf16(fam):
    check_prefill(fam)


def test_ragged_decode_matches_reference_bf16(fam):
    check_decode(fam)
