"""Interactive studio: job queue + profiles on the terminal.

Counterpart of the reference's PySide6 desktop app (MangaStudioMain.py +
MangaStudio_Data/, 3.7k LoC — job queue, per-job pipeline profiles,
reorder, pause, themes): a terminal front-end over the port's pipeline,
which runs on the CUDA card, with the reference's job management feature
set:

* named config profiles (create/edit/save/delete; eager validation)
* a job queue where EVERY job carries its own profile snapshot
  (``profile set`` after queueing does not mutate queued jobs)
* queue editing: ``move``/``remove``/``retry``/``clear``, persisted to
  disk so a studio restart resumes where it left off
* ``run`` with pause (Ctrl-C stops between jobs, queue state kept),
  per-stage progress and per-job wall times
* ``batch`` to run the pending queue through the batched pipeline
  (translate_batch: shared detection forwards, pooled OCR, batched
  translation, inpainting crops of several pages in shared buckets)

Profiles and the queue persist in ``PROFILE_DIR``, apart from the JAX
package's studio.

Run: ``python -m manga_image_translator_tpu_torch.studio``
"""
from __future__ import annotations

import asyncio
import cmd
import copy
import json
import os
import time
from typing import Dict, List, Optional

from .config import Config
from .device import resolve_device
from .mode.local import MangaTranslatorLocal
from .utils.log import init_logging

PROFILE_DIR = os.path.expanduser(
    '~/.config/manga-image-translator-tpu-torch')


def set_nested(cfg: dict, key: str, value: str):
    """Set a dotted ``key`` in a config dict to ``value`` (JSON-parsed when
    possible), validating the result against :class:`Config`. Returns
    ``None`` on success; on a validation error the change is rolled back
    and the error string is returned. Shared by the terminal studio and
    the GUI (studio_gui.py)."""
    keys = key.split('.')
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    try:
        value = json.loads(value) if isinstance(value, str) else value
    except ValueError:
        pass
    old = node.get(keys[-1], ...)
    node[keys[-1]] = value
    try:
        Config(**cfg)
        return None
    except Exception as e:
        if old is ...:
            del node[keys[-1]]
        else:
            node[keys[-1]] = old
        return str(e)


def unset_nested(cfg: dict, key: str) -> bool:
    """Remove a dotted ``key`` override; returns whether it was set."""
    keys = key.split('.')
    node = cfg
    for k in keys[:-1]:
        node = node.get(k, {})
        if not isinstance(node, dict):
            return False
    if keys[-1] in node:
        del node[keys[-1]]
        return True
    return False


class Studio(cmd.Cmd):
    intro = ('manga-image-translator studio (PyTorch, CUDA). '
             "Type 'help' for commands.\n")
    prompt = 'studio> '

    def __init__(self, translator_params: Optional[dict] = None):
        """``translator_params`` go to the pipeline's translator (for
        example ``{'use_gpu': False}`` from Python for the CPU)."""
        super().__init__()
        self.translator_params = dict(translator_params or {})
        # the pipeline runs on the card: fail here, not at the first job
        resolve_device(self.translator_params.get('use_gpu'))
        self.queue: List[Dict] = []
        self.profiles: Dict[str, dict] = {'default': {}}
        self.active_profile = 'default'
        self.dest = 'result-translated'
        self._load_state()

    # -- persistence -------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(PROFILE_DIR, name)

    def _load_state(self):
        try:
            with open(self._path('profiles.json'), encoding='utf8') as f:
                self.profiles.update(json.load(f))
        except (OSError, ValueError):
            pass
        try:
            with open(self._path('queue.json'), encoding='utf8') as f:
                self.queue = json.load(f)
            for job in self.queue:      # a crashed 'running' job is pending
                if job.get('status') == 'running':
                    job['status'] = 'pending'
        except (OSError, ValueError):
            pass

    def _save_profiles(self):
        os.makedirs(PROFILE_DIR, exist_ok=True)
        with open(self._path('profiles.json'), 'w', encoding='utf8') as f:
            json.dump(self.profiles, f, indent=2)

    def _save_queue(self):
        os.makedirs(PROFILE_DIR, exist_ok=True)
        with open(self._path('queue.json'), 'w', encoding='utf8') as f:
            json.dump(self.queue, f, indent=2)

    # -- profiles ----------------------------------------------------------

    def do_profile(self, arg):
        """profile                     -- show the active profile
        profile <name>                 -- switch to a profile
        profile list                   -- list profiles
        profile set <key> <value>      -- e.g. profile set translator.translator none
        profile unset <key>            -- remove an override
        profile save <name>            -- save current settings as a profile
        profile delete <name>          -- delete a profile"""
        parts = arg.split()
        if not parts:
            print(f'active: {self.active_profile}')
            print(json.dumps(self.profiles[self.active_profile], indent=2))
            return
        if parts[0] == 'list':
            for name in sorted(self.profiles):
                star = '*' if name == self.active_profile else ' '
                print(f'{star} {name}')
        elif parts[0] == 'set' and len(parts) >= 3:
            err = set_nested(self.profiles[self.active_profile], parts[1],
                             ' '.join(parts[2:]))
            if err is None:
                self._save_profiles()
                print('ok')
            else:
                print(f'invalid: {err}')
        elif parts[0] == 'unset' and len(parts) == 2:
            if unset_nested(self.profiles[self.active_profile], parts[1]):
                self._save_profiles()
                print('ok')
            else:
                print('not set')
        elif parts[0] == 'save' and len(parts) == 2:
            self.profiles[parts[1]] = copy.deepcopy(
                self.profiles[self.active_profile])
            self._save_profiles()
            print(f'saved profile {parts[1]}')
        elif parts[0] == 'delete' and len(parts) == 2:
            if parts[1] == 'default':
                print('cannot delete the default profile')
            elif parts[1] in self.profiles:
                del self.profiles[parts[1]]
                if self.active_profile == parts[1]:
                    self.active_profile = 'default'
                self._save_profiles()
                print(f'deleted {parts[1]}')
            else:
                print(f'unknown profile: {parts[1]}')
        elif parts[0] in self.profiles:
            self.active_profile = parts[0]
            print(f'switched to {parts[0]}')
        else:
            print(f'unknown profile: {parts[0]} '
                  f'(have: {", ".join(sorted(self.profiles))})')

    # -- queue -------------------------------------------------------------

    def add_job(self, path: str):
        """Queue one path with a SNAPSHOT of the active profile. Returns
        the new job dict, or None when the path does not exist."""
        if not os.path.exists(path):
            return None
        job = {
            'path': path,
            'profile': self.active_profile,
            'config': copy.deepcopy(self.profiles[self.active_profile]),
            'status': 'pending',
        }
        self.queue.append(job)
        return job

    def move_job(self, src: int, dst: int):
        job = self.queue.pop(src)
        self.queue.insert(dst, job)
        self._save_queue()

    def remove_jobs(self, idxs):
        removed = []
        for i in sorted({int(x) for x in idxs}, reverse=True):
            removed.append(self.queue.pop(i))
        self._save_queue()
        return removed

    def retry_failed(self) -> int:
        n = 0
        for job in self.queue:
            if job['status'] == 'failed':
                job['status'] = 'pending'
                job.pop('error', None)
                n += 1
        self._save_queue()
        return n

    def clear_finished(self):
        self.queue = [j for j in self.queue if j['status'] == 'pending']
        self._save_queue()

    def do_add(self, arg):
        """add <path> [path...] -- queue image files or folders with a
        SNAPSHOT of the active profile (later edits don't change the job)"""
        for path in arg.split():
            if self.add_job(path) is None:
                print(f'no such path: {path}')
            else:
                print(f'queued {path} ({self.active_profile})')
        self._save_queue()

    def do_queue(self, arg):
        """queue -- list queued jobs with status and timing"""
        if not self.queue:
            print('(empty)')
        for i, job in enumerate(self.queue):
            took = f' {job["took"]:.1f}s' if 'took' in job else ''
            err = f' — {job["error"]}' if job.get('error') else ''
            print(f'{i:3d} [{job["status"]:8s}] {job["path"]} '
                  f'({job["profile"]}){took}{err}')

    def do_move(self, arg):
        """move <from> <to> -- reorder a pending job"""
        try:
            src, dst = (int(x) for x in arg.split())
            self.move_job(src, dst)
            self.do_queue('')
        except (ValueError, IndexError):
            print('usage: move <from-index> <to-index>')

    def do_remove(self, arg):
        """remove <index> [index...] -- drop jobs from the queue"""
        try:
            for job in self.remove_jobs(arg.split()):
                print(f'removed {job["path"]}')
        except (ValueError, IndexError):
            print('usage: remove <index> [index...]')

    def do_retry(self, arg):
        """retry -- mark failed jobs pending again"""
        print(f'{self.retry_failed()} job(s) reset')

    def do_clear(self, arg):
        """clear -- drop finished/failed jobs (pending jobs stay)"""
        self.clear_finished()

    def do_dest(self, arg):
        """dest [folder] -- show or set the output folder"""
        if arg.strip():
            self.dest = arg.strip()
        print(f'output folder: {self.dest}')

    def do_job(self, arg):
        """job <index>                        -- show a job's config snapshot
        job <index> set <key> <value>         -- edit THIS job's pipeline
        job <index> unset <key>               -- drop one of its overrides
        (the reference studio edits per-job pipelines the same way; other
        jobs and the profile itself are untouched)"""
        parts = arg.split()
        if not parts:
            print('usage: job <index> [set <key> <value> | unset <key>]')
            return
        try:
            job = self.queue[int(parts[0])]
        except (ValueError, IndexError):
            print(f'no such job: {parts[0] if parts else ""}')
            return
        cfg = job.setdefault('config', {})
        if len(parts) == 1:
            print(f'{job["path"]} [{job["status"]}] '
                  f'(profile snapshot: {job["profile"]})')
            print(json.dumps(cfg, indent=2))
            return
        if parts[1] == 'set' and len(parts) >= 4:
            err = set_nested(cfg, parts[2], ' '.join(parts[3:]))
            if err is None:
                self._save_queue()
                print('ok')
            else:
                print(f'invalid: {err}')
        elif parts[1] == 'unset' and len(parts) == 3:
            if unset_nested(cfg, parts[2]):
                self._save_queue()
                print('ok')
            else:
                print('not set')
        else:
            print('usage: job <index> [set <key> <value> | unset <key>]')

    def do_status(self, arg):
        """status -- queue summary + per-stage timers of finished jobs
        (the pipeline's StageTimer report, surfaced per job and
        aggregated)"""
        counts: Dict[str, int] = {}
        for job in self.queue:
            counts[job['status']] = counts.get(job['status'], 0) + 1
        print(' '.join(f'{k}:{v}' for k, v in sorted(counts.items()))
              or '(empty queue)')
        agg: Dict[str, List[float]] = {}
        for i, job in enumerate(self.queue):
            stages = job.get('stage_ms')
            if not stages:
                continue
            line = ' | '.join(f'{k} {v:.0f}ms' for k, v in stages.items())
            print(f'{i:3d} {os.path.basename(job["path"])}: {line}')
            for k, v in stages.items():
                agg.setdefault(k, []).append(v)
        if agg:
            print('-- mean per stage --')
            for k, vs in agg.items():
                print(f'  {k}: {sum(vs) / len(vs):.0f}ms over {len(vs)} '
                      f'job(s)')

    # -- running -----------------------------------------------------------

    def _job_config(self, job: Dict) -> Config:
        return Config(**job.get(
            'config', self.profiles.get(job['profile'], {})))

    def do_run(self, arg):
        """run -- process pending jobs one by one (Ctrl-C pauses between
        jobs; 'run' again resumes)"""
        pending = [j for j in self.queue if j['status'] == 'pending']
        if not pending:
            print('queue empty')
            return
        try:
            asyncio.run(self._run_jobs(pending))
        except KeyboardInterrupt:
            print('\npaused — pending jobs kept; type run to resume')
        self._save_queue()

    async def _run_jobs(self, jobs: List[Dict], should_stop=None,
                        on_state=None):
        """Process ``jobs`` sequentially. ``should_stop()`` is polled
        between jobs (GUI Stop button — Ctrl-C covers the terminal);
        ``on_state(state_str)`` overrides the default progress print."""
        translator = MangaTranslatorLocal({'ignore_errors': True,
                                           **self.translator_params})
        current: List[Dict] = [None]

        async def hook(state, finished):
            # per-stage timers ride the progress channel as
            # 'stage-time:{name}:{ms}' (manga_translator.translate)
            if state.startswith('stage-time:'):
                _, name, ms = state.split(':', 2)
                if current[0] is not None:
                    current[0].setdefault('stage_ms', {})[name] = float(ms)
                return
            if on_state is not None:
                on_state(state)
            else:
                print(f'  [{state}]', flush=True)

        translator.add_progress_hook(hook)
        for job in jobs:
            if should_stop is not None and should_stop():
                break
            current[0] = job
            job.pop('stage_ms', None)
            job['status'] = 'running'
            self._save_queue()
            t0 = time.time()
            print(f'== {job["path"]}')
            try:
                cfg = self._job_config(job)
                await translator.translate_path(
                    job['path'], self.dest, {'config': cfg})
                job['status'] = 'done'
                job['took'] = time.time() - t0
                print(f'== done in {job["took"]:.1f}s')
            except Exception as e:
                job['status'] = 'failed'
                job['error'] = str(e)
                print(f'== failed: {e}')
            self._save_queue()

    def do_batch(self, arg):
        """batch -- run ALL pending jobs through the batched pipeline
        (shared detection forwards, pooled OCR, batched translation,
        inpainting crops in shared buckets); best for many pages with one
        profile"""
        pending = [j for j in self.queue if j['status'] == 'pending']
        if not pending:
            print('queue empty')
            return
        try:
            asyncio.run(self._run_batch(pending))
        except KeyboardInterrupt:
            print('\ninterrupted')
        self._save_queue()

    async def _run_batch(self, jobs: List[Dict]):
        from PIL import Image
        translator = MangaTranslatorLocal({'ignore_errors': True,
                                           **self.translator_params})
        images_with_configs = []
        expanded: List[Dict] = []
        for job in jobs:
            cfg = self._job_config(job)
            files = translator._collect_images([job['path']])
            for f in files:
                images_with_configs.append((Image.open(f), cfg))
                expanded.append({'job': job, 'file': f})
        print(f'batching {len(images_with_configs)} page(s)')
        t0 = time.time()
        ctxs = await translator.translate_batch(images_with_configs)
        os.makedirs(self.dest, exist_ok=True)
        for meta, ctx in zip(expanded, ctxs):
            out = translator._dest_path(meta['file'], self.dest)
            if ctx.result is not None:
                ctx.result.save(out)
        for job in jobs:
            job['status'] = 'done'
            job['took'] = time.time() - t0
        print(f'== batch done in {time.time() - t0:.1f}s')

    def do_quit(self, arg):
        """quit -- exit the studio"""
        return True

    do_exit = do_quit
    do_EOF = do_quit


def main():
    init_logging()
    Studio().cmdloop()


if __name__ == '__main__':
    main()
