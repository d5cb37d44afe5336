"""Root pytest hooks.

``pytest.ini`` deselects the ``perf`` and ``distill`` tests by default
(``-m "not perf and not distill"``), but a command line that passes its
own ``-m`` replaces that expression. A run with ``-m 'not slow'`` would
then bring back the two ~11-minute curriculum-distillation tests. Every
item marked ``distill`` or ``perf`` is therefore also marked ``slow``, so
``-m 'not slow'`` keeps them out as well. Run them with ``-m distill`` or
``-m perf``.
"""
import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.get_closest_marker("distill") or \
                item.get_closest_marker("perf"):
            item.add_marker(pytest.mark.slow)
