"""The port's imports point one way, from each layer of ``marlsnake_torch``
to the layers below it: core, rng and device < ops < utils < envs <
models < algo < the rest (parallel, cli, tools, examples, the benchmark
tables). Two sibling modules stay apart as well: the PPO trainer does not
load the DQN trainer, and the ActorCritic does not load the DQN's module.
Every import counts, those inside functions too."""

import ast
import pathlib

PKG = pathlib.Path(__file__).resolve().parents[1] / 'marlsnake_torch'

# lowest first; a top-level name not listed here is above them all
LAYERS = (('core', 'rng', 'device'), ('ops',), ('utils',), ('envs',),
          ('models',), ('algo',))
APART = {('algo', 'ppo_trainer'): ('algo', 'dqn_trainer'),
         ('models', 'ppo'): ('models', 'dqn')}


def _rank(parts) -> int:
    for rank, names in enumerate(LAYERS):
        if parts and parts[0] in names:
            return rank
    return len(LAYERS)


def _imported(node, package):
    """The package modules that an import statement names, as tuples of
    names below ``marlsnake_torch``."""
    if isinstance(node, ast.Import):
        dotted = [a.name for a in node.names]
    elif node.level:
        base = package[:len(package) - node.level + 1]
        stem = '.'.join(('marlsnake_torch',) + base
                        + ((node.module,) if node.module else ()))
        dotted = [stem] + [f'{stem}.{a.name}' for a in node.names]
    else:
        dotted = [node.module] + [f'{node.module}.{a.name}'
                                  for a in node.names]
    for name in dotted:
        parts = tuple(name.split('.'))
        if parts[0] != 'marlsnake_torch' or len(parts) < 2:
            continue
        rel = PKG.joinpath(*parts[1:])
        if rel.with_suffix('.py').exists() or rel.is_dir():
            yield parts[1:]


def test_imports_point_down_the_layers():
    bad = []
    for path in sorted(PKG.rglob('*.py')):
        me = path.relative_to(PKG).with_suffix('').parts
        package = me[:-1]
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for got in _imported(node, package):
                if _rank(got) > _rank(me) or APART.get(me) == got[:2]:
                    bad.append(f'{path.relative_to(PKG.parent)}:'
                               f'{node.lineno} imports {".".join(got)}')
    assert not bad, '\n'.join(bad)
