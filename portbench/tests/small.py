"""Cells of BENCHMARK.json cut to a size a CPU test can run: the same
traffic and solver settings, m a few tens, the pool a few tensors."""
import dataclasses

from harness import cell as cells


def small(name: str, m: int = 24, pool: int = 4, slots: int = 4):
    """The cell `name` at size m (ε kept valid under Thm II.1 where the
    configuration derives it from m), γ scaled with m."""
    c = cells.load(name)
    conf = dict(c.config, m=m, cluster_size=max(1, m // 10))
    solver = dict(conf["solver"])
    if solver["max_extraction_iters"]:
        solver.update(epsilon=0.5 / (m - conf["cluster_size"]) ** 2,
                      max_extraction_iters=m)
    conf["solver"] = solver
    if "engine" in conf:
        conf["engine"] = dict(conf["engine"], slots=slots)
    scale = m / c.config["m"]
    tr = dict(c.traffic, pool=pool, gamma=c.traffic["gamma"] * scale,
              clients=min(c.traffic["clients"], 2 * slots))
    return dataclasses.replace(c, config=conf, traffic=tr)
