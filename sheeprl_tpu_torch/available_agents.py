"""Print every algorithm the port registers, with its evaluation entry point
(counterpart of sheeprl_tpu/available_agents.py)::

    python -m sheeprl_tpu_torch.available_agents

A ``rich`` table where ``rich`` is installed, plain text columns where it is
not.
"""

from __future__ import annotations

from typing import List, Sequence

from sheeprl_tpu_torch.registry import algorithm_registry, evaluation_registry, register_all

TITLE = "sheeprl-tpu-torch Agents"
COLUMNS = ("Module", "Algorithm", "Entrypoint", "Decoupled", "Evaluated by")


def agent_rows() -> List[Sequence[str]]:
    """One row of :data:`COLUMNS` per registered algorithm, sorted by name."""
    register_all()
    rows = []
    for name in sorted(algorithm_registry):
        entry = algorithm_registry[name]
        ev = evaluation_registry.get(name)
        evaluated_by = f"{ev.module}.{ev.entrypoint.__name__}" if ev is not None else "Undefined"
        rows.append((entry.module, entry.name, entry.entrypoint.__name__, str(entry.decoupled), evaluated_by))
    return rows


def plain_table(rows: Sequence[Sequence[str]]) -> str:
    """``rows`` under :data:`COLUMNS` as left-aligned plain text."""
    widths = [max(len(str(r[i])) for r in (COLUMNS, *rows)) for i in range(len(COLUMNS))]
    lines = [TITLE] + ["  ".join(str(v).ljust(w) for v, w in zip(r, widths)).rstrip() for r in (COLUMNS, ["-" * w for w in widths], *rows)]
    return "\n".join(lines)


def available_agents() -> None:
    """Print the table: with ``rich`` where it imports, else as plain text."""
    rows = agent_rows()
    try:
        from rich.console import Console
        from rich.table import Table
    except ImportError:
        print(plain_table(rows), flush=True)
        return
    table = Table(title=TITLE)
    for column in COLUMNS:
        table.add_column(column)
    for row in rows:
        table.add_row(*row)
    Console().print(table)


main = available_agents


if __name__ == "__main__":
    available_agents()
