"""H.265/HEVC decoder subsystem (scaffolding).

Parameter-set parsing and NAL-unit plumbing mirror the reference
(h265.cpp:231-720); CTU decode (CABAC entropy, quad-tree, SAO) is the
next build phase — see SURVEY.md §2.1 for the reference component map.
"""
