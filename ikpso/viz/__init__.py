"""Offline visualization of chains, targets, colliders, swarms."""

from ikpso.viz.render import chain_segments, export_html, plot_scene, scene_dict
