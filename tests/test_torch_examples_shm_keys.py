"""The system-region examples register POSIX keys of their own processes.

The reference's four system-region examples create their regions under
fixed keys (``/input_simple``, ...), open with ``O_CREAT`` and unlink on
exit: two runs at once on one host, from two test files or two
checkouts, could unlink each other's region between its create and the
server's open.  The port's examples append their process id to each key,
and the suite (``tools/examples_suite.py``) runs the reference's through
``tools/own_shm_keys.py``, which does the same to them.  Here each of the
eight runs against one port ``Server(device="cpu")`` prints its PASS
line, and the server's registry saw every key with a process id and
never a fixed one."""

import os
import re
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

# each example's fixed keys, as the reference writes them
FIXED = {
    "simple_grpc_shm_client.py": ("/input_simple", "/output_simple"),
    "simple_grpc_shm_string_client.py": ("/grpc_in_str", "/grpc_out_str"),
    "simple_http_shm_client.py": ("/http_in_simple", "/http_out_simple"),
    "simple_http_shm_string_client.py": ("/http_in_str", "/http_out_str"),
}
OWN = re.compile(r"(/\w+?)_(\d+)")


@pytest.fixture(scope="module")
def registered():
    """``(outcomes, keys)``: the eight runs and the key of every system
    registration the server took meanwhile."""
    from client_tpu_torch.serve import Server

    keys = []
    with Server(device="cpu", grpc_port=0, http_port=0) as s:
        shm = s.engine.shm
        register = shm.register_system

        def recording(name, key, offset, byte_size):
            keys.append(key)
            return register(name, key, offset, byte_size)

        shm.register_system = recording
        runs = [ex.url_run(directory, n, s.grpc_address, s.http_address,
                           key=f"{side} {n}")
                for n in ex.SYSTEM_SHM
                for side, directory in (("port", ex.PORT_DIR),
                                        ("ref", ex.REFERENCE_DIR))]
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        try:
            outcomes = ex.run_all(runs, jobs=4, timeout=100, env=env)
        finally:
            del shm.register_system  # the class's method again
    return outcomes, keys


def test_the_fixed_keys_are_the_reference_ones():
    assert sorted(FIXED) == sorted(ex.SYSTEM_SHM)
    for name, keys in FIXED.items():
        text = open(os.path.join(ex.REFERENCE_DIR, name)).read()
        assert all(f'"{k}"' in text for k in keys), name
        port = open(os.path.join(ex.PORT_DIR, name)).read()
        assert not any(f'"{k}"' in port for k in keys), name


@pytest.mark.parametrize("name", sorted(FIXED))
def test_system_region_example_registers_keys_of_its_own(registered, name):
    outcomes, keys = registered
    for side in ("port", "ref"):
        out = outcomes[f"{side} {name}"]
        assert out.passed, out.describe()
    assert not set(FIXED[name]) & set(keys)
    pids = {}
    for key in keys:
        match = OWN.fullmatch(key)
        assert match, key
        if match.group(1) in FIXED[name]:
            pids.setdefault(match.group(2), set()).add(match.group(1))
    # the port's run and the reference's, each both of its keys
    assert len(pids) == 2, pids
    assert all(bases == set(FIXED[name]) for bases in pids.values()), pids
