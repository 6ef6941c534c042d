"""``repro_torch.kernels.compare_sass`` on a canned ``cuobjdump -sass``
listing (the tool itself runs where the CUDA toolkit is)."""

import subprocess

import pytest

from repro_torch.kernels import compare_sass as cs

LISTINGS = {
    "old.so": {
        "void (anonymous namespace)::plane_kernel<1, 1, unsigned char>"
        "(unsigned char const*, (anonymous namespace)::PlaneGeom)": "A\nB\n",
        "void (anonymous namespace)::product_kernel<4, short>(short const*, "
        "int)": "C\n",
        "(anonymous namespace)::split_parts_kernel(void const*, int)": "D\n",
    },
    "new.so": {
        "void (anonymous namespace)::plane_kernel<1, 1, unsigned char, 3, "
        "false>(unsigned char const*, (anonymous namespace)::PlaneGeom)":
            "A\nB\n",
        "void (anonymous namespace)::plane_kernel<1, 1, unsigned char, 3, "
        "true>(unsigned char const*, (anonymous namespace)::PlaneGeom)":
            "A\nX\n",
        "void (anonymous namespace)::product_kernel<4, short, false>(short "
        "const*, int, int)": "C\n",
        "(anonymous namespace)::split_parts_kernel(void const*, int)": "D\n",
    },
}


@pytest.fixture
def fake_tools(monkeypatch):
    """``cuobjdump -sass`` prints mangled stand-ins; ``c++filt`` maps them
    back to the listing's names."""
    mangled = {}

    def run(cmd, input=None, **kw):
        if cmd[0] == "c++filt":
            out = "\n".join(mangled[m] for m in input.split("\n"))
        else:
            text = ["Fatbin elf code:"]
            for i, (name, body) in enumerate(LISTINGS[cmd[-1]].items()):
                key = f"_Z{cmd[-1][:3]}{i}"
                mangled[key] = name
                text.append(f"\t\tFunction : {key}\n{body}")
            out = "\n".join(text)
        return subprocess.CompletedProcess(cmd, 0, stdout=out)

    monkeypatch.setattr(cs.subprocess, "run", run)


def test_kernels_are_keyed_by_template_name(fake_tools):
    assert sorted(cs.kernels("old.so")) == [
        "plane_kernel<1, 1, unsigned char>", "product_kernel<4, short>",
        "split_parts_kernel"]


@pytest.mark.parametrize("name,want", [
    ("plane_kernel<1, 1, unsigned char>",
     "plane_kernel<1, 1, unsigned char, 3, false>"),
    ("product_kernel<4, short>", "product_kernel<4, short, false>"),
    ("split_parts_kernel", "split_parts_kernel"),
])
def test_counterpart_appends_the_extra_arguments(name, want):
    extra = {"plane_kernel": "3, false", "product_kernel": "false"}
    assert cs.counterpart(name, extra) == want


def test_identical_builds_pass_and_a_changed_kernel_fails(fake_tools, capsys):
    extra = ["--extra", "plane_kernel=3, false",
             "--extra", "product_kernel=false"]
    assert cs.main(["old.so", "new.so", *extra]) == 0
    assert "3 identical, 0 different, 0 without" in capsys.readouterr().out
    # the SLAB variant's code differs from the old kernel's
    assert cs.main(["old.so", "new.so", "--extra", "plane_kernel=3, true",
                    "--extra", "product_kernel=false"]) == 1
    assert "differs: plane_kernel<1, 1, unsigned char>" in \
        capsys.readouterr().out
    # no --extra: the old names are not in the new build
    assert cs.main(["old.so", "new.so"]) == 1
    assert "2 without a counterpart" in capsys.readouterr().out


def test_column_padding_does_not_count(monkeypatch, capsys):
    """cuobjdump pads every line to the listing's longest instruction: a
    build that adds a kernel with longer instructions re-pads the others,
    which must still compare identical; a changed encoding must not."""
    line = "        /*0000*/{pad}LDC R1, c[0x0][0x28] ;{pad}/* 0x00000a00ff017b82 */"
    listings = {"old.so": {"k": line.format(pad="   ")},
                "new.so": {"k": line.format(pad="      ")},
                "bad.so": {"k": line.format(pad="   ").replace("17b82",
                                                              "17b83")}}

    def run(cmd, input=None, **kw):
        if cmd[0] == "c++filt":
            return subprocess.CompletedProcess(cmd, 0, stdout=input)
        body = listings[cmd[-1]]["k"]
        return subprocess.CompletedProcess(
            cmd, 0, stdout=f"Fatbin elf code:\n\t\tFunction : k\n{body}\n")

    monkeypatch.setattr(cs.subprocess, "run", run)
    assert cs.main(["old.so", "new.so"]) == 0
    assert "1 identical, 0 different" in capsys.readouterr().out
    assert cs.main(["old.so", "bad.so"]) == 1
