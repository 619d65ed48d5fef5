"""Targets for the daemonic processes of tests/test_torch_env_vector.py, and
the faulty env thunk of tests/test_torch_env_tracing.py (a spawned process
imports its target's module, so they live here, apart from the test modules
and their JAX imports)."""


def port_vector_kind(args, queue):
    """The kind of vector the port's make_vector_env builds in this process,
    and the warnings it gave."""
    import warnings

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        envs = make_vector_env(compose(args))
    queue.put((type(envs).__name__, [str(w.message) for w in caught]))
    envs.close()


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def gymnasium_async_vector(queue):
    """What the JAX package's make_vector_env builds for env.sync_env=False
    (gymnasium's AsyncVectorEnv), started in this process."""
    import gymnasium as gym

    try:
        envs = gym.vector.AsyncVectorEnv([_cartpole, _cartpole])
    except AssertionError as exc:
        queue.put(f"AssertionError: {exc}")
        return
    queue.put("started")
    envs.close()


class RaiseAtStep:
    """An env thunk whose env raises ``RuntimeError`` in its ``at_step``-th
    step, once per thunk object: ``RestartOnException`` rebuilds the env from
    the same thunk in the same process (a worker holds its own copy), and the
    rebuilt env steps on. It works on the JAX package's gymnasium envs and on
    the port's envs alike (it replaces the built env's ``step``)."""

    def __init__(self, thunk, at_step):
        self.thunk, self.at_step, self.fired = thunk, int(at_step), False

    def __call__(self):
        env = self.thunk()
        if self.fired:
            return env
        inner, steps = env.step, [0]

        def step(action):
            steps[0] += 1
            if steps[0] == self.at_step and not self.fired:
                self.fired = True
                raise RuntimeError(f"planted fault in step {self.at_step}")
            return inner(action)

        env.step = step
        return env
