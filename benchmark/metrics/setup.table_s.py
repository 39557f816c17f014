"""Seconds of the pipeline's line-list, opacity-table and forward-model
stages (stage_linelist, stage_opacity, stage_forward), the harness's span
around them, ended by a synchronise."""


def read(ctx):
    return ctx["spans"].get("setup.table")
