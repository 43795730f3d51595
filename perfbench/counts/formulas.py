"""Operation and byte counts computed from shapes, frozen with the
benchmark. A multiply-add is two FLOPs. Counts are of the work the
algorithm needs, not of what a kernel happens to do."""

from __future__ import annotations


def conv3x3(cin: int, cout: int, h: int, w: int) -> int:
    """A 3x3 'same' convolution's forward FLOPs over an h x w map."""
    return 2 * cin * cout * 9 * h * w


def linear(fin: int, fout: int) -> int:
    return 2 * fin * fout


def dqn_forward(h: int, w: int, c: int, actions: int) -> int:
    """One sample through Conv c->32->64->64 and FC 64hw->256->128->A."""
    return (conv3x3(c, 32, h, w) + conv3x3(32, 64, h, w)
            + conv3x3(64, 64, h, w) + linear(64 * h * w, 256)
            + linear(256, 128) + linear(128, actions))


def actor_critic_forward(h: int, w: int, c: int, actions: int) -> int:
    """One sample through the ActorCritic: conv c->32 at h x w, a 2x2
    pool, conv 32->32 at h/2 x w/2, the pools, and both heads over the
    128 pooled features (pooling and elementwise work left out)."""
    return (conv3x3(c, 32, h, w) + conv3x3(32, 32, h // 2, w // 2)
            + linear(128, 256) + linear(256, actions)
            + linear(128, 256) + linear(256, 1))


def backward(forward: int, first_layer: int) -> int:
    """A backward pass: the gradients of the weights and of the inputs
    of every layer, each as much as the forward, less the first layer's
    input gradient, which nothing needs."""
    return 2 * forward - first_layer


def env_state_bytes(h: int, w: int, n: int, ring_words: int) -> int:
    """One env's state as the step reads or writes it: grid (int32),
    direction, head (2), tail (2), ring words, ring head, ring length
    (int32 a snake), alive (a byte a snake), alive count, four episodic
    stats (float32 a snake), episode length."""
    return (4 * h * w + 4 * n * (1 + 2 + 2 + ring_words + 1 + 1) + n + 4
            + 4 * 4 * n + 4)


def step_output_bytes(h: int, w: int, n: int) -> int:
    """One env's step output: the 8-plane uint8 obs of every snake,
    reward (float32), done (a byte), rank (int32), four episodic stats
    (float32) a snake, and the episode-done flag."""
    return n * h * w * 8 + 4 * n + n + 4 * n + 4 * 4 * n + 1


def k1_bytes(h: int, w: int, n: int, ring_words: int, fruits: int,
             envs: int, pool_spawn: bool) -> int:
    """The bytes one launch of K1 (the step with auto-reset) needs: the
    state read and written once, the actions (int32), the draws (fruit
    respawn a snake, the reset's spawn draw, the reset's fruits; the
    procedural spawn's own four draws a snake are read only by resetting
    envs), and the step output written once. What only a resetting env
    reads (its pool row or its procedural draws, the empty board) is left
    out: under 0.01% of a launch at thousands of envs."""
    draws = 4 * n + (4 if pool_spawn else 0) + 4 * fruits
    per_env = (2 * env_state_bytes(h, w, n, ring_words) + 4 * n + draws
               + step_output_bytes(h, w, n))
    return envs * per_env


def procedural_reset_bytes(n: int, resets: int) -> int:
    """The procedural spawn's four float32 draws a snake of each env that
    resets."""
    return resets * n * 16
