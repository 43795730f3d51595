"""BENCHMARK.json and the files it names keep the benchmark's contract:
names, units, sources, bounds, the metrics each cell reports, and one
file a configuration, cell, driver and metric."""

import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
E2E_SOURCES = {'host_clock', 'device_trace'}
SOURCES = E2E_SOURCES | {'program_span', 'program_counter'}
WIDTH = re.compile(r'(hidden|intermediate|latent|state|projection|head|'
                   r'expansion|experts_per_tok|_dim$|_rank$)')


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(BENCH['paths']) <= 16
    assert all(PATH.match(p) and '..' not in p and not p.startswith('/')
               for p in BENCH['paths'])
    assert len(BENCH['command']) <= 32
    assert all(_line(w) for w in BENCH['command'])
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    cells = len(BENCH['workloads'])
    assert 1 <= cells <= 24 and 1 <= len(BENCH['configs']) <= 24
    assert 1 <= len(BENCH['end_to_end']) <= 16
    assert 1 <= len(BENCH['per_layer']) <= 128
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, cells // 4)


def test_names_units_and_unique():
    names = {}
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        got = [e['name'] for e in BENCH[group]]
        assert len(set(got)) == len(got), group
        for n in got:
            assert NAME.match(n), n
        names[group] = set(got)
    assert not names['end_to_end'] & names['per_layer']
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')


def test_configs():
    used = {w['config'] for w in BENCH['workloads']}
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['name'] in used
        assert _line(c['source']) and _line(c['why'])
        assert c['file'].startswith(tuple(p + '/' for p in BENCH['paths']))
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c['reduced'])
        body = json.load(open(os.path.join(ROOT, c['file'])))
        assert body['name'] == c['name'] and body['reduced'] == c['reduced']
        assert os.path.exists(os.path.join(
            harness.HERE, 'counts', f'{body["counts"]}.py'))


def test_cells_and_their_files():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert NAME.match(w['traffic'])
        cell = harness.Cell.find(w['name'])
        assert cell.workload['why'] == w['why']
        assert os.path.exists(os.path.join(
            harness.HERE, 'drivers', f'{cell.workload["driver"]}.py'))
        assert set(cell.workload['limits'])


def test_metrics_entries():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    cells = {w['name'] for w in BENCH['workloads']}
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in E2E_SOURCES
        assert 0.01 <= m['bound'] <= 0.25
        assert set(m.get('workloads', cells)) <= cells
    layers = {}
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in SOURCES and _line(m['layer'])
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        reports = set(e2e[m['moves']].get('workloads', cells))
        assert set(m.get('workloads', reports)) <= reports, m['name']
        layers.setdefault(m['layer'], []).append(m['name'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert os.path.exists(os.path.join(
            harness.HERE, 'metrics', f'{m["name"]}.py')), m['name']
    roofline = [m for m in BENCH['per_layer']
                if m['name'].endswith('_roofline') or 'mfu' in m['name']]
    assert all(m['unit'] == '%' for m in roofline)


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_reports_enough(cell):
    c = harness.Cell.find(cell)
    e2e = [m['name'] for m in c.metrics(False)]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert len(c.metrics(True)) >= 1


def test_run_seconds_fit_a_full_check():
    """A check of the full 24 cells fits its time: 2 + 14 * 24 runs at
    ``run_seconds`` + 60 s, 2 * 90 s of compiling a cell, 1200 s spare."""
    rs = BENCH['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
