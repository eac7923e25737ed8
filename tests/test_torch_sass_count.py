"""The SASS comparison of ntt_aie_tpu_torch/scripts/sass_count.py on
made-up cuobjdump text: no compiler and no card."""

from ntt_aie_tpu_torch.scripts import sass_count as S

SASS = """
        Function : _Z6kernelILb0EEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x00000a00ff017624 */
        /*0010*/                   EXIT ;                   /* 0x000000000000794d */
        Function : _ZN45_GLOBAL__N__0a1b2c3d_4_colpass_cu_12345678_1234other
        /*0000*/                   BRA 0x0 ;                /* 0x0 */
"""


def test_parse_sass_names_and_instructions():
    kernels = S.parse_sass(SASS)
    assert kernels["_Z6kernelILb0EEvv"] == [(0, "MOV R1, c[0x0][0x28]"),
                                            (0x10, "EXIT")]
    assert len(kernels) == 2
    assert any(k.startswith("_ZN45_GLOBAL__N_") for k in kernels)


def test_compare_differ_renamed_unmatched():
    got = S.compare({
        "parent": {"same": "a", "changed": "b", "old_name": "c"},
        "this": {"same": "a", "changed": "B", "new_name": "c", "new": "d"}})
    assert got == {"differ": ["changed"],
                   "renamed": {"parent": ["old_name"], "this": ["new_name"]},
                   "unmatched": {"this": ["new"]}}
