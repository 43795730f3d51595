"""The control on the card: the reference put in the program's place at
the precision below the one the configuration states (TF32 for the
learners' float32; the env's float32 picks in bfloat16) is not correct,
while the program is, each at the tiny size. The readings at the cells'
own sizes come from ``perfbench/readings.py --controls``."""

import pytest
import torch

from perfbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize('name', tiny.CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: TF32 and the step kernel exist '
                    'only there')
    c = tiny.cell(name)
    d = tiny.run(c, device='cuda')
    assert tiny.over(c, d.compared()) == {}
    assert tiny.over(c, d.controls()['control'])
