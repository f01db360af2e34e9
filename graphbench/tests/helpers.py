"""Small cells of the real configurations and mixes, cut to a scale the
CPU holds."""

from graphbench import harness


def small_cell(name: str, scale: int = 9, **traffic):
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, scale=scale)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell
