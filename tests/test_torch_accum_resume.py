"""Gradient accumulation across a resume: a run of the port's engine cut
between two micro-steps of one accumulation and resumed, against the
uninterrupted run, bit for bit on the CPU and over an epoch boundary."""

from monocon_tpu_torch.engine.engine import MonoConEngine
from test_torch_accum_engine import make_cfg, tree  # noqa: F401 -- fixture
from test_torch_checkpoint import FirstN
from torch_port_helpers import assert_same


def test_resume_mid_accumulation_is_bit_identical(tree, tmp_path):
    """Two epochs of 5 micro-steps with a checkpoint after every one. A
    runs through; B stops after micro-step 3 of epoch 1, between the two
    micro-steps of an accumulation; C, a fresh engine with another SEED,
    resumes B's checkpoint and finishes. C's weights, AdamW state, solver
    state (5 optimizer steps; no open accumulation, the one left open at
    the end of epoch 1 having closed on epoch 2's first micro-step) and
    loss history equal A's bit for bit."""
    def cfg(out, seed=0):
        c = make_cfg(tree, out, CKPT_PERIOD_STEPS=1)
        c.SOLVER.OPTIM.NUM_EPOCHS, c.SEED = 2, seed
        # DLA-46: an eighth of DLA-34's weights to save 27 times.
        c.MODEL.BACKBONE.NUM_LAYERS = 46
        return c

    engine_a = MonoConEngine(cfg(tmp_path / "a"), device="cpu")
    engine_a.train()
    engine_b = MonoConEngine(cfg(tmp_path / "b"), device="cpu")
    engine_b.train_loader = FirstN(engine_b.train_loader, 3)
    engine_b.train_one_epoch()
    assert (engine_b.solver.count, engine_b.solver.mini_step) == (1, 1)
    engine_c = MonoConEngine(cfg(tmp_path / "b", seed=12345), device="cpu")
    assert (engine_c.epochs, engine_c._resume_step_in_epoch,
            engine_c.cfg.SEED) == (1, 3, 0)
    assert (engine_c.solver.count, engine_c.solver.mini_step) == (1, 1)
    assert_same(engine_c.solver.state_dict(), engine_b.solver.state_dict())
    engine_c.train()

    assert engine_c.global_iters == engine_a.global_iters == 11
    assert engine_c.entire_losses == engine_a.entire_losses
    assert len(engine_a.entire_losses) == 10
    assert (engine_a.solver.count, engine_a.solver.mini_step) == (5, 0)
    assert_same(engine_c.model.state_dict(), engine_a.model.state_dict())
    assert_same(engine_c.optimizer.state_dict(),
                engine_a.optimizer.state_dict())
    assert_same(engine_c.solver.state_dict(), engine_a.solver.state_dict())
    assert engine_c.current_lr == engine_a.current_lr > 0
