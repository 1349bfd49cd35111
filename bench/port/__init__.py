"""How a configuration file reaches the port's config: bench/port/<kind>.py,
the kind the configuration's `reference` names, has

    fields(conf)       {port config field: value}: the file's sizes under
                       the port's names
    check(conf, cfg)   raises ValueError where the port's config `cfg`
                       (the registered arch's, with those fields) is not
                       the model the file states

bench/harness/program.py:arch_of calls them. A port module imports
nothing of the program: it reads the config object it is handed.
"""


def require(conf: dict, runs: dict) -> None:
    """Raise where the file states another value than the one the port
    runs ({file key: the port's value})."""
    for k, v in runs.items():
        if conf[k] != v:
            raise ValueError(f"{k} = {conf[k]}: the port runs {v}")
