"""Desktop GUI studio (tkinter).

Counterpart of the reference's PySide6 desktop app (MangaStudioMain.py +
MangaStudio_Data/app/ui/main_window.py, 3.7k LoC): a windowed front-end
over the pipeline with the reference's feature set —

* job queue: add files/folders, remove, duplicate, reorder, requeue,
  per-job pipeline overrides (ref: _add_job/_duplicate_selected_jobs/
  _move_job/_save_settings_to_job, main_window.py:1696-3006)
* settings panel GENERATED from the Config schema — every pipeline
  option grouped per stage, enum choices as dropdowns (ref builds its
  tabs dynamically from a settings list, main_window.py:403-489)
* named profiles: save/load/delete (ref: _save_profile/_load_profile/
  _delete_profile, main_window.py:1287-1386)
* run / batch-run / stop with per-stage progress and a log pane
  (ref: _start_pipeline_thread/_run_pipeline/_stop_pipeline/log,
  main_window.py:2249-2534)
* history of finished jobs with per-stage timers
* light/dark themes (ref: _apply_theme, main_window.py:2753)
* queue + profiles persisted to disk, shared with the terminal studio

Counterpart of the JAX package's ``studio_gui.py`` over the port's
``studio`` and ``config``: a job's translation runs through the port's
``MangaTranslatorLocal``, on the CUDA card.

The base image ships tkinter but not PySide6, so the widget toolkit is
tkinter/ttk. All state transitions and run control live in
:class:`StudioViewModel`, which is fully headless-testable; the
:class:`StudioGUI` Tk layer only renders view-state and forwards events
(this split is what the reference lacks — its logic is welded to Qt
signals — and is what lets CI exercise the GUI without a display).

Run: ``python -m manga_image_translator_tpu_torch.studio_gui``
"""
from __future__ import annotations

import asyncio
import copy
import json
import os
import queue
import threading
import time
from enum import Enum
from typing import Dict, List, Optional, Tuple

from pydantic import BaseModel

from .config import Config
from . import studio as studio_mod


def flatten_schema() -> List[Tuple[str, str, Optional[List[str]], object]]:
    """(dotted_key, type_name, enum_choices, default) for every pipeline
    option in the Config schema — drives the generated settings panel the
    way the reference's dynamic tabs are driven by its settings lists."""
    rows: List[Tuple[str, str, Optional[List[str]], object]] = []

    def walk(model: type, prefix: str):
        for name, field in model.model_fields.items():
            ann = field.annotation
            # unwrap Optional[X]
            args = getattr(ann, '__args__', ())
            if args:
                non_none = [a for a in args if a is not type(None)]
                if len(non_none) == 1:
                    ann = non_none[0]
            key = f'{prefix}{name}'
            if isinstance(ann, type) and issubclass(ann, BaseModel):
                walk(ann, key + '.')
                continue
            choices = None
            if isinstance(ann, type) and issubclass(ann, Enum):
                choices = [e.value for e in ann]
            default = field.default
            if isinstance(default, Enum):
                default = default.value
            rows.append((key, getattr(ann, '__name__', str(ann)),
                         choices, default))
    walk(Config, '')
    return rows


class StudioViewModel:
    """Headless GUI state machine over the shared studio engine.

    Every mutation returns ``None`` on success or an error string (the Tk
    layer shows it in the status bar); progress from the worker thread is
    drained via :meth:`poll_events`."""

    IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.webp', '.bmp')

    def __init__(self, translator_params: Optional[dict] = None):
        """``translator_params`` go to the pipeline's translator (for
        example ``{'use_gpu': False}`` from Python for the CPU); without a
        card and without that, the studio refuses to start."""
        self.studio = studio_mod.Studio(translator_params)
        self.events: 'queue.Queue[tuple]' = queue.Queue()
        self.theme = 'light'
        self._worker: Optional[threading.Thread] = None
        self._stop_requested = False
        self._load_gui_state()

    # -- persistence (GUI-only state: theme, window prefs) ------------------

    def _gui_state_path(self) -> str:
        return self.studio._path('gui.json')

    def _load_gui_state(self):
        try:
            with open(self._gui_state_path(), encoding='utf8') as f:
                state = json.load(f)
            self.theme = state.get('theme', 'light')
            self.studio.dest = state.get('dest', self.studio.dest)
        except (OSError, ValueError):
            pass

    def save_gui_state(self):
        os.makedirs(studio_mod.PROFILE_DIR, exist_ok=True)
        with open(self._gui_state_path(), 'w', encoding='utf8') as f:
            json.dump({'theme': self.theme, 'dest': self.studio.dest}, f)

    def toggle_theme(self) -> str:
        self.theme = 'dark' if self.theme == 'light' else 'light'
        self.save_gui_state()
        return self.theme

    # -- queue view + actions ------------------------------------------------

    def job_rows(self) -> List[dict]:
        rows = []
        for i, job in enumerate(self.studio.queue):
            rows.append({
                'index': i,
                'name': os.path.basename(job['path']),
                'path': job['path'],
                'profile': job['profile'],
                'status': job['status'],
                'took': f"{job['took']:.1f}s" if 'took' in job else '',
                'error': job.get('error', ''),
            })
        return rows

    def add_paths(self, paths: List[str]) -> Optional[str]:
        bad = []
        for p in paths:
            if self.studio.add_job(p) is None:
                bad.append(p)
        self.studio._save_queue()
        return f'no such path: {", ".join(bad)}' if bad else None

    def add_folder(self, folder: str) -> Optional[str]:
        if not os.path.isdir(folder):
            return f'not a folder: {folder}'
        files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.lower().endswith(self.IMAGE_EXTS))
        if not files:
            return 'no images in folder'
        return self.add_paths(files)

    def remove(self, idxs: List[int]) -> Optional[str]:
        running = [i for i in idxs
                   if self.studio.queue[i]['status'] == 'running']
        if running:
            return 'cannot remove a running job'
        self.studio.remove_jobs(idxs)
        return None

    def duplicate(self, idxs: List[int]):
        """Reference feature: _duplicate_selected_jobs — copies a job with
        its config snapshot, re-queued as pending."""
        for i in sorted(idxs):
            src = self.studio.queue[i]
            dup = copy.deepcopy(src)
            dup['status'] = 'pending'
            dup.pop('error', None)
            dup.pop('took', None)
            dup.pop('stage_ms', None)
            self.studio.queue.append(dup)
        self.studio._save_queue()

    def move(self, idx: int, delta: int) -> Optional[str]:
        dst = idx + delta
        if not (0 <= idx < len(self.studio.queue)
                and 0 <= dst < len(self.studio.queue)):
            return 'out of range'
        self.studio.move_job(idx, dst)
        return None

    def retry(self) -> int:
        return self.studio.retry_failed()

    def requeue(self, idxs: List[int]):
        """Reference feature: _requeue_job — push a finished/failed job
        back to pending."""
        for i in idxs:
            job = self.studio.queue[i]
            if job['status'] != 'running':
                job['status'] = 'pending'
                job.pop('error', None)
                job.pop('took', None)
                job.pop('stage_ms', None)
        self.studio._save_queue()

    def clear_finished(self):
        self.studio.clear_finished()

    def set_dest(self, path: str):
        self.studio.dest = path
        self.save_gui_state()

    # -- profiles + settings -------------------------------------------------

    def profile_names(self) -> List[str]:
        return sorted(self.studio.profiles)

    @property
    def active_profile(self) -> str:
        return self.studio.active_profile

    def switch_profile(self, name: str) -> Optional[str]:
        if name not in self.studio.profiles:
            return f'unknown profile: {name}'
        self.studio.active_profile = name
        return None

    def save_profile_as(self, name: str) -> Optional[str]:
        if not name.strip():
            return 'profile name required'
        self.studio.profiles[name] = copy.deepcopy(
            self.studio.profiles[self.studio.active_profile])
        self.studio.active_profile = name
        self.studio._save_profiles()
        return None

    def delete_profile(self, name: str) -> Optional[str]:
        if name == 'default':
            return 'cannot delete the default profile'
        if name not in self.studio.profiles:
            return f'unknown profile: {name}'
        del self.studio.profiles[name]
        if self.studio.active_profile == name:
            self.studio.active_profile = 'default'
        self.studio._save_profiles()
        return None

    def profile_overrides(self) -> Dict[str, object]:
        """Flattened dotted-key view of the active profile's overrides."""
        out: Dict[str, object] = {}

        def walk(node: dict, prefix: str):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f'{prefix}{k}.')
                else:
                    out[f'{prefix}{k}'] = v
        walk(self.studio.profiles[self.studio.active_profile], '')
        return out

    def set_profile_key(self, key: str, value: str) -> Optional[str]:
        err = studio_mod.set_nested(
            self.studio.profiles[self.studio.active_profile], key, value)
        if err is None:
            self.studio._save_profiles()
        return err

    def unset_profile_key(self, key: str) -> Optional[str]:
        if studio_mod.unset_nested(
                self.studio.profiles[self.studio.active_profile], key):
            self.studio._save_profiles()
            return None
        return 'not set'

    def set_job_key(self, idx: int, key: str, value: str) -> Optional[str]:
        job = self.studio.queue[idx]
        err = studio_mod.set_nested(job.setdefault('config', {}), key, value)
        if err is None:
            self.studio._save_queue()
        return err

    def job_config_json(self, idx: int) -> str:
        return json.dumps(self.studio.queue[idx].get('config', {}), indent=2)

    # -- history / status ----------------------------------------------------

    def history_rows(self) -> List[dict]:
        rows = []
        for i, job in enumerate(self.studio.queue):
            if job['status'] not in ('done', 'failed'):
                continue
            stage = job.get('stage_ms') or {}
            rows.append({
                'index': i,
                'name': os.path.basename(job['path']),
                'status': job['status'],
                'took': f"{job['took']:.1f}s" if 'took' in job else '',
                'stages': ' | '.join(f'{k} {v:.0f}ms'
                                     for k, v in stage.items()),
                'error': job.get('error', ''),
            })
        return rows

    # -- run control -----------------------------------------------------------

    @property
    def is_running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start(self, batch: bool = False) -> Optional[str]:
        if self.is_running:
            return 'already running'
        pending = [j for j in self.studio.queue if j['status'] == 'pending']
        if not pending:
            return 'queue empty'
        self._stop_requested = False
        self._worker = threading.Thread(
            target=self._run_worker, args=(pending, batch), daemon=True)
        self._worker.start()
        return None

    def stop(self):
        """Stop between jobs (the reference's _stop_pipeline also only
        interrupts at a safe point: it kills the job subprocess)."""
        self._stop_requested = True

    def _run_worker(self, pending: List[dict], batch: bool):
        t0 = time.time()
        try:
            if batch:
                asyncio.run(self.studio._run_batch(pending))
            else:
                asyncio.run(self.studio._run_jobs(
                    pending,
                    should_stop=lambda: self._stop_requested,
                    on_state=lambda s: self.events.put(('progress', s))))
        except Exception as e:       # surfaced in the log pane, never raised
            self.events.put(('log', f'run failed: {e}'))
        finally:
            self.studio._save_queue()
            self.events.put(('finished', time.time() - t0))

    def poll_events(self) -> List[tuple]:
        out = []
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                return out


# ---------------------------------------------------------------------------
# Tk layer: renders StudioViewModel. Kept thin — no business logic here.
# ---------------------------------------------------------------------------

THEMES = {
    'light': {'bg': '#f4f4f4', 'fg': '#202020', 'field': '#ffffff',
              'accent': '#2f6fde'},
    'dark': {'bg': '#23252b', 'fg': '#e8e8e8', 'field': '#2e3138',
             'accent': '#5b93f5'},
}


class StudioGUI:
    POLL_MS = 150

    def __init__(self, vm: Optional[StudioViewModel] = None):
        import tkinter as tk
        from tkinter import ttk
        self.tk = tk
        self.ttk = ttk
        self.vm = vm or StudioViewModel()
        self.root = tk.Tk()
        self.root.title('manga-image-translator studio (PyTorch, CUDA)')
        self.root.geometry('1100x640')
        self._build()
        self._apply_theme(self.vm.theme)
        self._refresh_all()
        self.root.after(self.POLL_MS, self._poll)

    # -- construction -----------------------------------------------------

    def _build(self):
        tk, ttk = self.tk, self.ttk
        top = ttk.Frame(self.root)
        top.pack(fill='both', expand=True)

        # left: job queue
        left = ttk.Frame(top)
        left.pack(side='left', fill='both', expand=True, padx=4, pady=4)
        cols = ('name', 'profile', 'status', 'took')
        self.jobs = ttk.Treeview(left, columns=cols, show='headings',
                                 selectmode='extended')
        for c, w in zip(cols, (260, 90, 80, 60)):
            self.jobs.heading(c, text=c.title())
            self.jobs.column(c, width=w)
        self.jobs.pack(fill='both', expand=True)
        btns = ttk.Frame(left)
        btns.pack(fill='x')
        for text, cmd in (
                ('Add Files', self._add_files),
                ('Add Folder', self._add_folder),
                ('Remove', self._remove),
                ('Duplicate', self._duplicate),
                ('Up', lambda: self._move(-1)),
                ('Down', lambda: self._move(+1)),
                ('Requeue', self._requeue),
                ('Retry Failed', self._retry),
                ('Clear Done', self._clear)):
            ttk.Button(btns, text=text, command=cmd).pack(
                side='left', padx=1, pady=2)

        # right: notebook (settings / log / history)
        right = ttk.Frame(top, width=420)
        right.pack(side='right', fill='both', padx=4, pady=4)
        nb = ttk.Notebook(right)
        nb.pack(fill='both', expand=True)
        nb.add(self._build_settings_tab(nb), text='Settings')
        nb.add(self._build_log_tab(nb), text='Log')
        nb.add(self._build_history_tab(nb), text='History')

        # bottom: run bar
        bar = ttk.Frame(self.root)
        bar.pack(fill='x', padx=4, pady=4)
        self.btn_run = ttk.Button(bar, text='Start', command=self._start)
        self.btn_run.pack(side='left')
        self.btn_batch = ttk.Button(bar, text='Batch Run',
                                    command=lambda: self._start(batch=True))
        self.btn_batch.pack(side='left', padx=2)
        self.btn_stop = ttk.Button(bar, text='Stop', command=self.vm.stop,
                                   state='disabled')
        self.btn_stop.pack(side='left', padx=2)
        ttk.Button(bar, text='Output…', command=self._pick_dest).pack(
            side='left', padx=8)
        ttk.Button(bar, text='Theme', command=self._toggle_theme).pack(
            side='right')
        self.status = tk.StringVar(value='ready')
        ttk.Label(bar, textvariable=self.status).pack(side='left', padx=8)
        self.progress = ttk.Progressbar(bar, mode='indeterminate',
                                        length=160)
        self.progress.pack(side='right', padx=8)

    def _build_settings_tab(self, parent):
        tk, ttk = self.tk, self.ttk
        tab = ttk.Frame(parent)
        prof = ttk.Frame(tab)
        prof.pack(fill='x', pady=2)
        ttk.Label(prof, text='Profile:').pack(side='left')
        self.profile_var = tk.StringVar(value=self.vm.active_profile)
        self.profile_box = ttk.Combobox(
            prof, textvariable=self.profile_var,
            values=self.vm.profile_names(), state='readonly', width=14)
        self.profile_box.pack(side='left', padx=2)
        self.profile_box.bind('<<ComboboxSelected>>', self._switch_profile)
        ttk.Button(prof, text='Save As…',
                   command=self._save_profile).pack(side='left', padx=2)
        ttk.Button(prof, text='Delete',
                   command=self._delete_profile).pack(side='left')

        # schema-generated option editor: key dropdown (+ per-key enum
        # choices), value entry, current overrides listing
        edit = ttk.Frame(tab)
        edit.pack(fill='x', pady=2)
        self.schema = {k: (t, c, d) for k, t, c, d in flatten_schema()}
        self.key_var = tk.StringVar()
        self.key_box = ttk.Combobox(edit, textvariable=self.key_var,
                                    values=sorted(self.schema), width=30)
        self.key_box.pack(side='left')
        self.key_box.bind('<<ComboboxSelected>>', self._on_key_pick)
        self.val_var = tk.StringVar()
        self.val_box = ttk.Combobox(edit, textvariable=self.val_var,
                                    width=16)
        self.val_box.pack(side='left', padx=2)
        ttk.Button(edit, text='Set', command=self._set_key).pack(side='left')
        ttk.Button(edit, text='Unset',
                   command=self._unset_key).pack(side='left', padx=2)

        self.overrides = ttk.Treeview(
            tab, columns=('key', 'value'), show='headings')
        self.overrides.heading('key', text='Override')
        self.overrides.heading('value', text='Value')
        self.overrides.pack(fill='both', expand=True, pady=2)
        return tab

    def _build_log_tab(self, parent):
        tab = self.ttk.Frame(parent)
        self.log = self.tk.Text(tab, height=10, state='disabled')
        self.log.pack(fill='both', expand=True)
        return tab

    def _build_history_tab(self, parent):
        tab = self.ttk.Frame(parent)
        cols = ('name', 'status', 'took', 'stages')
        self.history = self.ttk.Treeview(tab, columns=cols, show='headings')
        for c, w in zip(cols, (160, 60, 60, 260)):
            self.history.heading(c, text=c.title())
            self.history.column(c, width=w)
        self.history.pack(fill='both', expand=True)
        return tab

    # -- theme --------------------------------------------------------------

    def _apply_theme(self, name: str):
        t = THEMES[name]
        style = self.ttk.Style(self.root)
        style.theme_use('clam')
        style.configure('.', background=t['bg'], foreground=t['fg'],
                        fieldbackground=t['field'])
        style.configure('Treeview', background=t['field'],
                        foreground=t['fg'], fieldbackground=t['field'])
        style.map('TButton', background=[('active', t['accent'])])
        self.root.configure(bg=t['bg'])
        self.log.configure(bg=t['field'], fg=t['fg'])

    def _toggle_theme(self):
        self._apply_theme(self.vm.toggle_theme())

    # -- event handlers (thin: delegate to the view-model) -------------------

    def _selected(self) -> List[int]:
        return [self.jobs.index(i) for i in self.jobs.selection()]

    def _report(self, err: Optional[str]):
        self.status.set(err or 'ok')
        self._refresh_all()

    def _add_files(self):
        from tkinter import filedialog
        paths = filedialog.askopenfilenames(
            filetypes=[('Images', ' '.join(
                '*' + e for e in self.vm.IMAGE_EXTS))])
        if paths:
            self._report(self.vm.add_paths(list(paths)))

    def _add_folder(self):
        from tkinter import filedialog
        folder = filedialog.askdirectory()
        if folder:
            self._report(self.vm.add_folder(folder))

    def _remove(self):
        self._report(self.vm.remove(self._selected()))

    def _duplicate(self):
        self.vm.duplicate(self._selected())
        self._refresh_all()

    def _move(self, delta: int):
        sel = self._selected()
        if len(sel) == 1:
            self._report(self.vm.move(sel[0], delta))

    def _requeue(self):
        self.vm.requeue(self._selected())
        self._refresh_all()

    def _retry(self):
        self.status.set(f'{self.vm.retry()} job(s) reset')
        self._refresh_all()

    def _clear(self):
        self.vm.clear_finished()
        self._refresh_all()

    def _pick_dest(self):
        from tkinter import filedialog
        folder = filedialog.askdirectory()
        if folder:
            self.vm.set_dest(folder)
            self.status.set(f'output: {folder}')

    def _switch_profile(self, _ev=None):
        self._report(self.vm.switch_profile(self.profile_var.get()))

    def _save_profile(self):
        from tkinter import simpledialog
        name = simpledialog.askstring('Save profile', 'Profile name:')
        if name:
            self._report(self.vm.save_profile_as(name))

    def _delete_profile(self):
        self._report(self.vm.delete_profile(self.profile_var.get()))

    def _on_key_pick(self, _ev=None):
        _t, choices, default = self.schema.get(
            self.key_var.get(), (None, None, None))
        self.val_box.configure(values=choices or [])
        cur = self.vm.profile_overrides().get(self.key_var.get(), default)
        self.val_var.set('' if cur is None else json.dumps(cur)
                         if not isinstance(cur, str) else cur)

    def _set_key(self):
        self._report(self.vm.set_profile_key(self.key_var.get(),
                                             self.val_var.get()))

    def _unset_key(self):
        self._report(self.vm.unset_profile_key(self.key_var.get()))

    def _start(self, batch: bool = False):
        err = self.vm.start(batch=batch)
        if err:
            self.status.set(err)
            return
        self.btn_run.configure(state='disabled')
        self.btn_batch.configure(state='disabled')
        self.btn_stop.configure(state='normal')
        self.progress.start(80)
        self.status.set('running…')

    # -- refresh loop ---------------------------------------------------------

    def _append_log(self, line: str):
        self.log.configure(state='normal')
        self.log.insert('end', line + '\n')
        self.log.see('end')
        self.log.configure(state='disabled')

    def _refresh_all(self):
        for item in self.jobs.get_children():
            self.jobs.delete(item)
        for row in self.vm.job_rows():
            self.jobs.insert('', 'end', values=(
                row['name'], row['profile'], row['status'], row['took']))
        for item in self.history.get_children():
            self.history.delete(item)
        for row in self.vm.history_rows():
            self.history.insert('', 'end', values=(
                row['name'], row['status'], row['took'], row['stages']))
        self.profile_box.configure(values=self.vm.profile_names())
        self.profile_var.set(self.vm.active_profile)
        for item in self.overrides.get_children():
            self.overrides.delete(item)
        for k, v in sorted(self.vm.profile_overrides().items()):
            self.overrides.insert('', 'end', values=(k, v))

    def _poll(self):
        for ev in self.vm.poll_events():
            if ev[0] == 'progress':
                self.status.set(ev[1])
                self._refresh_all()
            elif ev[0] == 'log':
                self._append_log(ev[1])
            elif ev[0] == 'finished':
                self.progress.stop()
                self.btn_run.configure(state='normal')
                self.btn_batch.configure(state='normal')
                self.btn_stop.configure(state='disabled')
                self.status.set(f'finished in {ev[1]:.1f}s')
                self._append_log(f'run finished in {ev[1]:.1f}s')
                self._refresh_all()
        self.root.after(self.POLL_MS, self._poll)

    def run(self):
        self.root.mainloop()


def main():
    from .utils.log import init_logging
    init_logging()
    StudioGUI().run()


if __name__ == '__main__':
    main()
